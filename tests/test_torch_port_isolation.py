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
        "models.swin", "models.convnext", "drive_alt_factories", "parallel",
        "parallel.distributed", "parallel.mesh", "utils.tuners", "data_loading.human",
        "models.layers", "models.resnet", "models.fpn", "models.rpn", "models.roi_heads",
        "kernels._build", "diff_tsv_ranks", "quality_instrument", "recalibrate_bn")]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
              " or m.split('.')[0] in ('pets_face_recognition_tpu', 'cv2', 'pandas', 'PIL',"
              " 'sklearn', 'matplotlib')]\n"
              "assert not bad, bad\nprint('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
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
    env["OMP_NUM_THREADS"] = "1"
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


# JAX public names the port leaves out on purpose (ROADMAP §1): sharding
# names of one SPMD program, XLA routes that the kernels replace, JAX-only
# helpers and converters of torch checkpoints into flax trees
LEFT_OUT = {
    "losses": {"SumDetectionLoss"},
    "models.roi_heads": {"postprocess_detections"},
    "ops.homography": {"warp_affine_two_pass"},
    "ops.masks": {"paste_mask_np"},
    "ops.nms": {"batched_nms"},
    "ops.pallas_roi_align": {"multilevel_roi_align_pallas", "multilevel_roi_align_pallas_diff"},
    "ops.pallas_warp": {"warp_affine_batch_pallas"},
    "ops.roi_align": {"multilevel_roi_align_dense", "multilevel_roi_align_separable",
                      "roi_align"},
    "parallel": {"shard_map_compat"},
    "parallel.mesh": {"batch_sharding", "replicated"},
    "utils": {"enable_compilation_cache"},
    "utils.collate": {"detection_collate_fn", "detection_collate_list_fn",
                      "list_img_rec_collate_fn"},
    "utils.optim": {"wrap_gradient_transform"},
    "utils.preprocs": {"AugCombo", "aug_combo", "clahe", "imagenet_normalize",
                       "to_model_input"},
    "utils.torch_convert": {"assert_tree_shapes", "convert_detection_model",
                            "convert_fe_embedder", "convert_resnet", "convert_swin",
                            "state_dict_to_numpy"},
    "utils.torchvision_layouts": {"fe_controller_sd", "keypointrcnn_resnet50_fpn_sd",
                                  "maskrcnn_resnet50_fpn_sd", "resnet50_sd"},
}


# the JAX package's reduced-precision knobs (ROADMAP §1 leaves none out): a
# flax module's compute ``dtype`` field and the factories' and entry points'
# dtype arguments, each with its port counterpart and their common default
DTYPE_KNOBS = (
    ("models.resnet", "ResNet", "dtype", "models.resnet", "ResNet", "dtype"),
    ("models.resnet", "Bottleneck", "dtype", "models.resnet", "Bottleneck", "dtype"),
    ("models.resnet", "BasicBlock", "dtype", "models.resnet", "BasicBlock", "dtype"),
    ("models.embedder", "resnet50_embedder", "dtype", "models.embedder", "resnet50_embedder",
     "dtype"),
    ("models.fpn", "FPN", "dtype", "models.fpn", "FPN", "dtype"),
    ("models.fpn", "BackboneWithFPN", "dtype", "models.fpn", "BackboneWithFPN", "dtype"),
    ("models.rpn", "RPNHead", "dtype", "models.rpn", "RPNHead", "dtype"),
    ("models.roi_heads", "TwoMLPHead", "dtype", "models.roi_heads", "TwoMLPHead", "dtype"),
    ("models.roi_heads", "MaskHead", "dtype", "models.roi_heads", "MaskHead", "dtype"),
    ("models.roi_heads", "KeypointHead", "dtype", "models.roi_heads", "KeypointHead", "dtype"),
    ("models.rcnn", "GeneralizedRCNN", "dtype", "models.rcnn", "GeneralizedRCNN", "dtype"),
    ("models.mobilenet_v3", "MobileNetV3Large", "dtype", "models.mobilenet_v3",
     "MobileNetV3Large", "dtype"),
    ("ops.homography", "align_crop", "compute_dtype", "ops.homography", "align_crop",
     "compute_dtype"),
    ("ops.pallas_warp", "warp_affine_batch_pallas", "compute_dtype", "ops.homography",
     "warp_perspective_batch_cuda", "compute_dtype"),
    ("ops.pallas_warp", "warp_affine_batch_pallas", "out_dtype", "ops.homography",
     "warp_perspective_batch_cuda", "out_dtype"),
    ("serving", "EmbeddingService", "warp_dtype", "serving", "EmbeddingService", "warp_dtype"),
    ("config_presets", "build_fe_config", "compute_dtype", "config_presets", "build_fe_config",
     "compute_dtype"),
    ("models.quant", "QuantConv", "dtype", "models.quant", "QuantConv", "dtype"),
    ("models.swin", "WindowAttention", "dtype", "models.swin", "WindowAttention", "dtype"),
    ("models.swin", "SwinBlock", "dtype", "models.swin", "SwinBlock", "dtype"),
    ("models.swin", "PatchMerging", "dtype", "models.swin", "PatchMerging", "dtype"),
    ("models.swin", "StageModule", "dtype", "models.swin", "StageModule", "dtype"),
    ("models.swin", "SwinTransformer", "dtype", "models.swin", "SwinTransformer", "dtype"),
    ("models.convnext", "ConvNeXtBlock", "dtype", "models.convnext", "ConvNeXtBlock", "dtype"),
    ("models.convnext", "ConvNeXt", "dtype", "models.convnext", "ConvNeXt", "dtype"),
)
# the JAX service's landmark rule and crop size, with their defaults
SERVICE_KNOBS = (
    ("serving", "EmbeddingService", "crop_size", "serving", "EmbeddingService", "crop_size"),
    ("serving", "EmbeddingService", "min_distance", "serving", "EmbeddingService",
     "min_distance"),
)


def _jax_default(module: str, name: str, arg: str) -> str:
    """The source text of the default of ``arg`` of JAX's ``name`` in
    ``module``: a flax module's field, or a function's or ``__init__``'s
    keyword."""
    import ast

    path = REPO / "pets_face_recognition_tpu" / (module.replace(".", "/") + ".py")
    for node in ast.walk(ast.parse(path.read_text())):
        if getattr(node, "name", None) != name:
            continue
        if isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and getattr(stmt.target, "id", "") == arg:
                    return ast.unparse(stmt.value)
            node = next(n for n in node.body if getattr(n, "name", "") == "__init__")
        args = node.args.args[-len(node.args.defaults):]
        return ast.unparse(node.args.defaults[[a.arg for a in args].index(arg)])
    raise KeyError((module, name, arg))


def test_reduced_precision_knobs_have_port_counterparts():
    """Each JAX dtype knob, and the service's ``crop_size`` and
    ``min_distance``, has its port counterpart under the same name with the
    same default (``jnp.bfloat16`` is ``torch.bfloat16``; a literal, such as
    ``build_fe_config``'s ``"auto"`` or ``(224, 224)``, is the same value),
    and ``PFR_INPUT_DTYPE`` is read by both preprocessors."""
    import ast
    import importlib
    import inspect

    from pets_face_recognition_tpu_torch.preprocessor import input_dtype

    src = (REPO / "pets_face_recognition_tpu" / "preprocessor" / "__init__.py").read_text()
    assert '"PFR_INPUT_DTYPE"' in src and "PFR_INPUT_DTYPE" in inspect.getsource(input_dtype)
    for j_mod, j_name, j_arg, p_mod, p_name, p_arg in DTYPE_KNOBS + SERVICE_KNOBS:
        src = _jax_default(j_mod, j_name, j_arg)
        try:
            want = ast.literal_eval(src)
        except ValueError:
            want = getattr(torch, src.split(".")[-1])
        port = getattr(importlib.import_module(f"pets_face_recognition_tpu_torch.{p_mod}"),
                       p_name)
        got = inspect.signature(port).parameters[p_arg].default
        assert got == want, (p_mod, p_name, p_arg, got, want)


def _public_names(root: Path) -> dict[str, set[str]]:
    import ast

    out = {}
    for path in sorted(root.rglob("*.py")):
        mod = ".".join(path.relative_to(root).with_suffix("").parts)
        mod = mod[: -len(".__init__")] if mod.endswith(".__init__") else mod
        tree = ast.parse(path.read_text())
        out[mod] = {n.name for n in tree.body
                    if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}
    return out


def test_public_names_match_the_jax_package_but_those_left_out():
    """Every function and class the JAX package defines at a module's top level
    is defined somewhere in the port, but exactly the names ROADMAP lists as
    left out."""
    jax_names = _public_names(REPO / "pets_face_recognition_tpu")
    port = _public_names(PORT)
    everywhere = set().union(*port.values())
    missing = {m: sorted(n for n in names if n not in everywhere)
               for m, names in jax_names.items()}
    missing = {m: set(v) for m, v in missing.items() if v}
    assert missing == LEFT_OUT


# the JAX tools the port carries, each with the port module that holds its
# public names
PORTED_TOOLS = {"quality_instrument.py": "quality_instrument",
                "diff_tsv_ranks.py": "diff_tsv_ranks",
                "recalibrate_bn.py": "recalibrate_bn"}


def test_ported_tools_keep_the_jax_tools_public_names():
    """Every top-level function and class of the ported JAX tools is defined
    in its port module, and the hard corpus's generator in ``smoke_data``."""
    tools = _public_names(REPO / "tools")
    port = _public_names(PORT)
    for tool, module in PORTED_TOOLS.items():
        names = tools[tool[:-len(".py")]]
        assert names and names <= port[module], (tool, names - port[module])
    assert "make_kashtanka_hard" in tools["make_smoke_datasets"]
    assert "make_kashtanka_hard" in port["smoke_data"]


def test_quality_tools_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    """``quality_instrument`` and ``recalibrate_bn``, as the entry points
    above: the card unless ``--device cpu``."""
    from pets_face_recognition_tpu_torch import quality_instrument, recalibrate_bn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: quality_instrument.main(["--data", str(tmp_path), "--gt",
                                                  str(tmp_path / "gt.json")]),
                 lambda: recalibrate_bn.main(["--ckpt", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
