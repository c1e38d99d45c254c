"""The port stands alone: it imports neither JAX nor the JAX package, its entry
points default to CUDA and raise without it, and its kernels build only from
its own sources."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pets_face_recognition_tpu_torch import (eval_landmark, generate_tsv, main_keypoints,
                                             resolve_device, retrieval)
from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
from pets_face_recognition_tpu_torch.kernels import _build
from pets_face_recognition_tpu_torch.pipelines import build_retrieval_models
from pets_face_recognition_tpu_torch.preprocessor import Preproc3
from pets_face_recognition_tpu_torch.serving import EmbeddingService, build_serving_models

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "pets_face_recognition_tpu_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|pets_face_recognition_tpu)\b(?!_torch)",
                       re.MULTILINE)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_importing_the_port_loads_no_jax():
    modules = [f"pets_face_recognition_tpu_torch.{m}" for m in (
        "serving", "device", "weights", "kernels", "ops.nms", "ops.roi_align", "ops.homography",
        "ops.anchors", "ops.boxes", "models.rcnn", "models.embedder", "models.mobilenet_v3",
        "losses", "data",
        "utils.optim", "engine.train_state", "engine.detector_controller",
        "engine.trainer", "profile_serving", "kernel_ab", "retrieval", "native",
        "utils.collate", "preprocessor", "preprocessor.align", "pipelines", "generate_tsv",
        "utils", "data_loading", "data_loading.dataset", "data_loading.lmd_dataset",
        "data_loading.loader", "engine.detection_metrics", "engine.logging",
        "engine.checkpoint", "config_presets", "main", "main_keypoints", "eval_landmark",
        "losses.losses", "losses.large_margin", "engine.metrics", "engine.controller",
        "data_loading.pairs", "native.png", "utils.preprocs", "smoke_data", "eval_fe",
        "transform_reproduce", "transform_dataset", "ops.masks", "prepare_tables",
        "data_loading.oxford", "data_loading.transforms", "main_detection", "eval_detection",
        "models.quant", "models.ptq", "near_tie", "score_detection", "score_landmark",
        "models.swin", "models.convnext", "drive_alt_factories")]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
              " or m.split('.')[0] in ('pets_face_recognition_tpu', 'cv2', 'pandas', 'PIL',"
              " 'sklearn', 'matplotlib')]\n"
              "assert not bad, bad\nprint('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


NOT_ON_THE_CARD_PATH = re.compile(r"^(\s*)(import|from)\s+(cv2|pandas|PIL|sklearn|matplotlib)\b",
                                  re.MULTILINE)
# PIL only as the CPU fallback where no native JPEG route is installed, and in
# chip_smoke.py to measure the native decode against PIL's libjpeg where PIL is
PIL_FALLBACKS = {"serving.py", "generate_tsv.py", "chip_smoke.py"}


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_cv2_pandas_or_pil_on_the_card_path(path):
    for indent, _, name in NOT_ON_THE_CARD_PATH.findall(path.read_text()):
        assert name == "PIL" and indent and path.name in PIL_FALLBACKS, \
            f"{path} imports {name}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_serving_models()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EmbeddingService(torch.nn.Identity(), torch.nn.Identity())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KeyPointsController().init_state(0, model=torch.nn.Linear(1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_retrieval_models()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Preproc3(torch.nn.Identity())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        retrieval.pairwise_card_scores(np.zeros((1, 2), np.float32), np.zeros((1, 2), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_tsv.main(["--data", str(REPO)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main_keypoints.main(KeyPointsController, ["--config", str(REPO)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_landmark.main(["--ckpt", str(REPO)])
    assert resolve_device("cpu") == torch.device("cpu")


def test_fe_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """The feature extractor's and the transform's entry points, as those above."""
    from pets_face_recognition_tpu_torch import (eval_fe, main, transform_dataset,
                                                 transform_reproduce)
    from pets_face_recognition_tpu_torch.engine.controller import Controller

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Controller(None).init_state(0, model=torch.nn.Linear(1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main.main(None, ["--config", str(REPO)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_fe.main(["--ckpt", str(REPO)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transform_dataset.main(["--input", str(REPO), "--output", str(REPO)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transform_reproduce.main(["--data-root", str(REPO)])


def test_mask_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """Mask R-CNN's entry points and pipelines, as those above."""
    from pets_face_recognition_tpu_torch import pipelines, prepare_tables, transform_dataset
    from pets_face_recognition_tpu_torch.preprocessor import (Preproc4, Preproc5, Preproc6)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: pipelines.mask_detector(),
                 lambda: build_retrieval_models(body=True),
                 lambda: pipelines.build_body_pipeline(*(torch.nn.Identity(),) * 3),
                 lambda: Preproc4(torch.nn.Identity()), lambda: Preproc5(torch.nn.Identity()),
                 lambda: Preproc6(torch.nn.Identity()),
                 lambda: prepare_tables.main(["--data", str(REPO)]),
                 lambda: generate_tsv.main(["--data", str(REPO), "--body"]),
                 lambda: transform_dataset.main(["--input", str(REPO), "--output", str(REPO),
                                                 "--pipeline", "body"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_mask_training_modules_keep_pil_and_cv2_off():
    """The Oxford data path, the rotation and the collate read and resize in
    numpy and torch: no PIL or cv2 import at any depth of those modules."""
    for rel in ("data_loading/oxford.py", "data_loading/transforms.py", "utils/collate.py",
                "native/png.py", "main_detection.py", "eval_detection.py"):
        text = (PORT / rel).read_text()
        assert not re.search(r"^\s*(import|from)\s+(cv2|PIL)\b", text, re.MULTILINE), rel


def test_kernel_build_is_one_nvcc_call_over_the_port_sources():
    srcs = _build.sources()
    assert [p.name for p in srcs] == ["nms.cu", "roi_align.cu", "roi_align_backward.cu",
                                      "warp.cu"]
    for src in srcs:
        text = src.read_text()
        assert "torch/" not in text and "ATen" not in text and "pybind" not in text
        assert 'extern "C"' in text
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.library_path().parent == _build.BUILD_DIR
    code = "\n".join(line for line in Path(_build.__file__).read_text().splitlines()
                     if re.match(r"\s*(import|from)\s", line))
    assert "cpp_extension" not in code and "ninja" not in code


def test_int8_path_and_scorers_load_no_pil_cv2_pandas_or_sklearn(tmp_path):
    """An int8 calibrate-and-serve of a small detector and embedder, the PTQ
    workflow with its state file, ``near_tie`` and both scorers over a small
    table run in a process that never loads PIL, cv2, pandas or
    scikit-learn."""
    code = f"""
import pickle, sys
import numpy as np, torch
from pets_face_recognition_tpu_torch import near_tie, score_detection, score_landmark
from pets_face_recognition_tpu_torch.models import ptq, quant, rcnn
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
det = rcnn.keypointrcnn_resnet50_fpn(stage_sizes=(1, 1, 1, 1), quant="calibrate",
                                     quant_kp="calibrate", rpn_pre_nms_top_n_test=16,
                                     rpn_post_nms_top_n_test=4).eval()
emb = resnet50_embedder(8, stage_sizes=(1, 1, 1, 1), quant="calibrate").eval()
x = torch.rand(1, 64, 64, 3)
for name, m in (("det", det), ("emb", emb)):
    r = ptq.register(ptq.PTQServing(name, m))
    r.calibrate(x)
    r.serve(x)
ptq.save_quant_state(r"{tmp_path / 'qs.pkl'}")
anno = r"{tmp_path / 'anno.pickle'}"
entry = {{"Head": {{"x": 10, "y": 10, "width": 50, "height": 50}},
         "Left eye": {{"x": 20, "y": 30}}, "Right eye": {{"x": 40, "y": 30}},
         "Nose": {{"x": 30, "y": 50}}, "resolution": (100, 100)}}
pickle.dump([{{"a.jpg": [entry]}}, {{}}], open(anno, "wb"))
score_detection.compute_scores_data_25([{{"query": "a.jpg", "detections": "[[10, 10, 60, 60]]",
                                        "scores": "[0.9]"}}], "Head", anno)
score_landmark.compute_scores_data_25([{{"query": "a.jpg", "Left eye": "[20, 30]",
                                       "Right eye": "[40, 30]", "Nose": "[30, 50]"}}], anno)
bad = [m for m in sys.modules if m.split(".")[0] in ("PIL", "cv2", "pandas", "sklearn")]
assert not bad, bad
print("clean")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
    assert "Dog Head AP at 0.5 = 1.0" in out.stdout and "Dog NME = 0.0" in out.stdout


def test_variant_factories_default_to_cuda_and_raise_without_it(monkeypatch):
    """``keypoint_detector(variant=...)`` and the ``Preproc7``-``13`` pipelines,
    as the entry points above."""
    from pets_face_recognition_tpu_torch import pipelines
    from pets_face_recognition_tpu_torch.preprocessor import Preproc7, Preproc13

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: pipelines.keypoint_detector(variant="v3"), Preproc7, Preproc13,
                 lambda: pipelines.embedder("fe_dog_head", 0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_alt_factories_drive_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """``drive_alt_factories`` (and its ``drive()``), as the entry points
    above: the card unless ``--device cpu``."""
    from pets_face_recognition_tpu_torch import drive_alt_factories

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: drive_alt_factories.main(["--only", "mobile_net_v3_large_rcnn"]),
                 lambda: drive_alt_factories.drive("x", torch.nn.Identity, 64, False)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
