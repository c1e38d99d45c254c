"""The head retrieval chain with ``PFR_KEYPOINT_ARCH=mobile`` against the JAX
chain on the CPU, on shared weights: ``Preproc3`` with the MobileNetV3
keypoint R-CNN (full width, serving budgets 128 / 16) on the first four
photos of the committed corpus, and ``generate_tsv`` end to end over a split
of those photos against ``generate_tsv_to_reproduce1.prepare_data`` with JAX
``Preproc3`` closures.

The embedders are cut to one block a stage at the production width (512);
the detection threshold is 0 (random weights rarely score above 0.9). JAX
pools through its gather route (the dense limit set to 0): at 320 x 320 its
mobile detector would take the dense einsum, which rounds the levels and
the sampling weights to bfloat16 (``multilevel_roi_align_dense``'s default
``compute_dtype``), while both gathers and the port pool in float32.
"""

import importlib
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
from PIL import Image
import jax.numpy as jnp

from pets_face_recognition_tpu.models import embedder as j_embedder
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.ops.homography import warp_perspective as j_warp_perspective
from pets_face_recognition_tpu.preprocessor import Preproc3 as JPreproc3
from pets_face_recognition_tpu import retrieval as jr
from pets_face_recognition_tpu_torch import generate_tsv, pipelines, retrieval, weights
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
from pets_face_recognition_tpu_torch.models.mobilenet_v3 import MobileNetV3Large
from pets_face_recognition_tpu_torch.ops.homography import alignment_homographies
from pets_face_recognition_tpu_torch.preprocessor import DEFAULT_BASE_PTS, Preproc3

from test_torch_port_models import randomize

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
j_generate = importlib.import_module("generate_tsv_to_reproduce1")

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
BUDGETS = dict(rpn_pre_nms_top_n_test=128, rpn_post_nms_top_n_test=16)
CORPUS = REPO / "pets_face_recognition_tpu_torch" / "testdata" / "kashtanka_test"


def first_photos(n: int = 4) -> list[Path]:
    return sorted(CORPUS.rglob("*.jpg"))[:n]


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(41)
    mp = pytest.MonkeyPatch()
    mp.setattr(j_rcnn.GeneralizedRCNN, "DENSE_ROI_ALIGN_MAX_CELLS", 0)
    j_det = j_rcnn.mobile_net_v3_large_keypoint_rcnn(**BUDGETS)
    det_vars = randomize(jax.eval_shape(j_det.init, jax.random.PRNGKey(0),
                                        jnp.zeros((1, 320, 320, 3))), rng)
    j_emb = j_embedder.EmbeddingModel(backbone=j_resnet.ResNet(stage_sizes=STAGES))
    emb_shape = jax.eval_shape(j_emb.init, jax.random.PRNGKey(1), jnp.zeros((1, 224, 224, 3)))
    dog_vars, cat_vars = randomize(emb_shape, rng), randomize(emb_shape, rng)
    sds = weights.retrieval_state_dicts(det_vars, dog_vars, cat_vars)
    det_fn = jax.jit(lambda x: j_det.apply(det_vars, x))
    j_fes = {t: jax.jit(lambda x, v=v: j_emb.apply(v, x)) for t, v in ((1, dog_vars),
                                                                         (2, cat_vars))}
    yield dict(sds=sds, det_fn=det_fn, j_fes=j_fes)
    mp.undo()


def port_models(sds, arch: str):
    """``pipelines.build_retrieval_models`` for ``arch`` on the CPU, the
    detector given the JAX weights (strict), the embedders cut to one block a
    stage with theirs."""
    det, _, _ = pipelines.build_retrieval_models("cpu", 0, arch)
    det.load_state_dict(sds[0], strict=True)
    embs = []
    for sd in sds[1:]:
        emb = resnet50_embedder(512, stage_sizes=STAGES)
        emb.load_state_dict(sd, strict=True)
        embs.append(emb.eval())
    return (det, *embs)


def test_mobile_preproc3_matches_jax(models):
    """``Preproc3.batch`` with the mobile detector on the first four corpus
    photos: equal validity and rounded landmarks; crops within 1e-3 on
    [0, 1] of JAX ``warp_perspective`` of the same homography (the two sides
    invert and project the map in other orders), and within 8 levels, mean
    below 0.5, of the JAX pipeline's cv2 crop (cv2 snaps sample positions to
    1/32 px), as the ResNet chain's test holds them."""
    imgs = []
    for p in first_photos():
        with Image.open(p) as im:
            imgs.append(np.asarray(im.convert("RGB")))
    want_crops, want_valid, want_raw = JPreproc3(model_fn=models["det_fn"], thr=0.0).batch(imgs)
    det, _, _ = port_models(models["sds"], "mobile")
    crops, valid, raw = Preproc3(det, thr=0.0, device="cpu").batch(imgs)
    np.testing.assert_array_equal(valid, want_valid)
    assert valid.sum() >= 2, "too few valid photos to compare"
    np.testing.assert_array_equal(raw["keypoints"], want_raw["keypoints"])
    Hs = alignment_homographies(torch.from_numpy(raw["keypoints"]),
                                torch.from_numpy(DEFAULT_BASE_PTS))
    for i in np.nonzero(valid)[0]:
        got = crops[i].numpy()
        same_h = np.asarray(j_warp_perspective(jnp.asarray(imgs[i], jnp.float32),
                                               jnp.asarray(Hs[i].numpy()), (224, 224)))
        np.testing.assert_allclose(got / 255.0, same_h / 255.0, rtol=0, atol=1e-3)
        diff = np.abs(got - want_crops[i])
        assert diff.max() <= 8.0 and diff.mean() < 0.5, (i, diff.max(), diff.mean())


@pytest.fixture(scope="module")
def chains(models, tmp_path_factory):
    """A split of the first photo of the first card of each of the corpus'
    four folders (4 dog cards), through the JAX chain and through
    ``generate_tsv.main`` with ``PFR_KEYPOINT_ARCH=mobile``."""
    root = tmp_path_factory.mktemp("kashtanka_mobile")
    for side in ("found", "lost"):
        for sub in (side, f"extra_{side}"):
            card = sorted((CORPUS / side / sub).iterdir())[0]
            dst = root / side / sub / card.name
            dst.mkdir(parents=True)
            shutil.copy(card / "card.json", dst / "card.json")
            shutil.copy(card / "0.jpg", dst / "0.jpg")
    j_pre = JPreproc3(model_fn=models["det_fn"], thr=0.0)

    def j_head(img, animal_type):
        try:
            aligned = j_pre(img)
        except (AssertionError, ValueError, OSError):
            return None
        return np.asarray(models["j_fes"][animal_type](jnp.asarray(aligned[None]) / 255.0))[0]

    j_db = j_generate.prepare_data(root, j_head, None)
    tmp = tmp_path_factory.mktemp("out")
    j_dump_path = tmp / "jax.npz"
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("PFR_SCORES_DUMP", str(j_dump_path))
        jr._SCORES_DUMP.clear()
        j_rows = jr.create_table(j_db)
        jr.write_tsv(j_rows, tmp / "jax.tsv")      # writes the dump too
        jr._SCORES_DUMP.clear()
        built = []

        def build(dev, seed, arch):
            built.append(arch)
            return port_models(models["sds"], arch)

        mp.setattr(generate_tsv, "build_retrieval_models", build)
        mp.setenv("PFR_KEYPOINT_ARCH", "mobile")
        mp.setenv("PFR_RETRIEVAL_THR", "0.0")
        mp.setenv("PFR_SCORES_DUMP", str(tmp / "port.npz"))
        out = tmp / "pred.tsv"
        assert generate_tsv.main(["--data", str(root), "--output", str(out), "--device", "cpu",
                                  "--stock-preds", str(tmp / "none.tsv")]) == 0
    finally:
        mp.undo()
    return dict(j_rows=j_rows, j_dump=retrieval.load_scores_dump(j_dump_path),
                dump=retrieval.load_scores_dump(tmp / "port.npz"), out=out, built=built)


def test_mobile_chain_scores_match_jax(chains):
    """``generate_tsv`` reads ``PFR_KEYPOINT_ARCH=mobile`` and builds the
    MobileNetV3 detector; the same queries as the JAX chain, each score row
    within 1e-4 of JAX's and no rank flip across a larger gap."""
    assert chains["built"] == ["mobile"]
    lines = chains["out"].read_text().splitlines()
    assert [line.split("\t")[0] for line in lines[1:]] == list(chains["j_rows"]["query"])
    assert len(lines) >= 2
    report = retrieval.near_tie_report(chains["j_dump"], chains["dump"])
    assert not (report["only_a"] or report["only_b"] or report["gallery_only_a"]
                or report["gallery_only_b"]), report
    assert report["max_score_drift"] <= 1e-4, report
    assert report["max_flip_float_gap"] <= 1e-4, report


def test_keypoint_arch_is_read_and_checked(monkeypatch):
    """``PFR_KEYPOINT_ARCH``: ``resnet50`` by default, ``mobile`` builds the
    MobileNetV3 detector in eval mode, anything else raises."""
    monkeypatch.delenv("PFR_KEYPOINT_ARCH", raising=False)
    assert pipelines.keypoint_arch() == "resnet50"
    monkeypatch.setenv("PFR_KEYPOINT_ARCH", "mobile")
    assert pipelines.keypoint_arch() == "mobile"
    det, dog, cat = pipelines.build_retrieval_models("cpu", 0, "mobile")
    assert isinstance(det.backbone.body, MobileNetV3Large)
    assert not any(m.training for mod in (det, dog, cat) for m in mod.modules())
    monkeypatch.setenv("PFR_KEYPOINT_ARCH", "swin")
    with pytest.raises(ValueError, match="PFR_KEYPOINT_ARCH"):
        generate_tsv.main(["--device", "cpu"])
