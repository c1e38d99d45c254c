"""The port's head retrieval chain against the JAX package's on the CPU, on
shared weights: ``Preproc3`` (letterbox, detect, landmarks back on the photo,
the > 5 px rule, the aligned crop of the original photo), the head pipeline
and ``generate_tsv`` over a kashtanka split written by
``tools/make_smoke_datasets.py``.

The models are cut to one block a stage at the production widths (FPN 256,
keypoint head 512, embedders 512), with random weights carried over from the
JAX variables (``weights.retrieval_state_dicts``). The detection threshold is
0: random weights rarely score above the production 0.9.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pets_face_recognition_tpu.models import embedder as j_embedder
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.ops.homography import warp_perspective as j_warp_perspective
from pets_face_recognition_tpu.preprocessor import Preproc3 as JPreproc3
from pets_face_recognition_tpu.preprocessor.align import align as j_align
from pets_face_recognition_tpu import retrieval as jr
from pets_face_recognition_tpu_torch import generate_tsv, retrieval, weights
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
from pets_face_recognition_tpu_torch.models.rcnn import keypointrcnn_resnet50_fpn
from pets_face_recognition_tpu_torch.ops.homography import (alignment_homographies,
                                                            warp_perspective_batch)
from pets_face_recognition_tpu_torch.pipelines import build_head_pipeline
from pets_face_recognition_tpu_torch.preprocessor import DEFAULT_BASE_PTS, Preproc3, align

from test_torch_port_models import randomize

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
j_generate = importlib.import_module("generate_tsv_to_reproduce1")
make_smoke_datasets = importlib.import_module("make_smoke_datasets")

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
PRE, POST = 32, 8


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(21)
    cfg = j_rcnn.RCNNConfig(num_classes=2, num_keypoints=3, box_detections_per_img=1,
                            rpn_pre_nms_top_n_test=PRE, rpn_post_nms_top_n_test=POST)
    j_det = j_rcnn.GeneralizedRCNN(
        backbone=j_fpn.BackboneWithFPN(backbone=j_resnet.ResNet(
            stage_sizes=STAGES, features_only=True, frozen_stats=True)), cfg=cfg)
    det_vars = randomize(jax.eval_shape(j_det.init, jax.random.PRNGKey(0),
                                        jnp.zeros((1, 128, 128, 3))), rng)
    j_emb = j_embedder.EmbeddingModel(backbone=j_resnet.ResNet(stage_sizes=STAGES))
    emb_shape = jax.eval_shape(j_emb.init, jax.random.PRNGKey(1), jnp.zeros((1, 224, 224, 3)))
    dog_vars, cat_vars = randomize(emb_shape, rng), randomize(emb_shape, rng)

    det = keypointrcnn_resnet50_fpn(stage_sizes=STAGES, rpn_pre_nms_top_n_test=PRE,
                                    rpn_post_nms_top_n_test=POST)
    dog = resnet50_embedder(512, stage_sizes=STAGES)
    cat = resnet50_embedder(512, stage_sizes=STAGES)
    for module, sd in zip((det, dog, cat),
                          weights.retrieval_state_dicts(det_vars, dog_vars, cat_vars)):
        module.load_state_dict(sd, strict=True)
    det_fn = jax.jit(lambda x: j_det.apply(det_vars, x))
    j_fes = {t: jax.jit(lambda x, v=v: j_emb.apply(v, x)) for t, v in ((1, dog_vars),
                                                                         (2, cat_vars))}
    return dict(det_fn=det_fn, j_fes=j_fes, det=det.eval(), dog=dog.eval(), cat=cat.eval())


def photos():
    """Photos whose letterbox to 128 is exact in cv2 and in PyTorch (scale 1,
    and exact 2x downscales), so both detectors see the same pixels."""
    rng = np.random.RandomState(4)
    shapes = [(128, 128), (256, 256), (256, 192), (192, 256)]
    return [make_smoke_datasets._pet_image(rng, size=max(s))[: s[0], : s[1]] for s in shapes]


@pytest.fixture(scope="module")
def preproc3_pair(models):
    imgs = photos()
    want = JPreproc3(model_fn=models["det_fn"], thr=0.0, input_size=(128, 128)).batch(imgs)
    pre = Preproc3(models["det"], thr=0.0, input_size=(128, 128), device="cpu")
    return imgs, want, pre.batch(imgs), pre


def test_preproc3_validity_and_landmarks_match_jax(preproc3_pair):
    """Equal validity and equal rounded landmarks on the photos; scores and
    boxes within float32 rounding of a conv chain."""
    _, (_, want_valid, want_raw), (_, valid, raw), _ = preproc3_pair
    np.testing.assert_array_equal(valid, want_valid)
    assert valid.sum() >= 2, "too few valid photos to compare crops"
    np.testing.assert_array_equal(raw["keypoints"], want_raw["keypoints"])
    np.testing.assert_allclose(raw["scores"], want_raw["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(raw["boxes"], want_raw["boxes"], rtol=1e-4, atol=1e-2)


def test_preproc3_crops_match_the_jax_warp_and_cv2(preproc3_pair):
    """Crops of the original photos. Against JAX ``warp_perspective`` of the
    same homography within 1e-3 on the [0, 1] scale, as the serving slice's
    crops: the two sides invert H and project the grid in other orders, and
    float32 rounding of a sample position near 200 px (~2e-5 px) moves a
    sample by up to ~1e-2 of 255 levels at the photos' sharpest edges.
    Against the JAX pipeline's ``cv2.warpPerspective`` crop within 8 levels
    of 255, with a mean below 0.5: cv2 snaps each sample position to 1/32 px,
    a shift of up to 1/64 px on each axis, which moves a bilinear sample by
    at most 2 x 255 / 64 ~ 8 levels where neighbouring pixels differ by 255."""
    imgs, (want_crops, _, _), (crops, valid, raw), _ = preproc3_pair
    Hs = alignment_homographies(torch.from_numpy(raw["keypoints"]),
                                torch.from_numpy(DEFAULT_BASE_PTS))
    for i in np.nonzero(valid)[0]:
        got = crops[i].numpy()
        same_h = np.asarray(j_warp_perspective(jnp.asarray(imgs[i], jnp.float32),
                                               jnp.asarray(Hs[i].numpy()), (224, 224)))
        np.testing.assert_allclose(got / 255.0, same_h / 255.0, rtol=0, atol=1e-3)
        diff = np.abs(got - want_crops[i])
        assert diff.max() <= 8.0 and diff.mean() < 0.5, (diff.max(), diff.mean())
    assert not crops[~valid].any()


def test_preproc3_call_and_serve_batch(models, preproc3_pair):
    """``__call__`` returns the crop or raises ``AssertionError``; landmarks as
    ints for metrics; zero padding to ``serve_batch`` keeps every result."""
    imgs, _, (crops, valid, raw), pre = preproc3_pair
    i = int(np.nonzero(valid)[0][0])
    np.testing.assert_array_equal(pre(imgs[i]).numpy(), crops[i].numpy())
    with pytest.raises(AssertionError):
        Preproc3(models["det"], thr=1.1, input_size=(128, 128), device="cpu")(imgs[i])
    kps = Preproc3(models["det"], thr=0.0, input_size=(128, 128), return_for_metrics=True,
                   device="cpu")(imgs[i])
    assert kps.dtype.kind == "i"
    np.testing.assert_array_equal(kps, raw["keypoints"][i].astype(int))
    padded = Preproc3(models["det"], thr=0.0, input_size=(128, 128), serve_batch=6,
                      device="cpu").batch(imgs)
    np.testing.assert_array_equal(padded[1], valid)
    np.testing.assert_array_equal(padded[2]["keypoints"], raw["keypoints"])
    with pytest.raises(ValueError, match="serve_batch"):
        Preproc3(models["det"], thr=0.0, input_size=(128, 128), serve_batch=2,
                 device="cpu").batch(imgs)


def test_align_matches_jax():
    """The reference's single-image ``align`` (rounded-centroid 4-point
    homography, then the warp) on a photo: within 1e-3 on the [0, 1] scale,
    as the crops above; ``dsize`` may carry a channel entry."""
    img = photos()[1].astype(np.float32)
    pts = np.array([[100.0, 90.0], [160.0, 95.0], [128.0, 150.0]], np.float32)
    want = np.asarray(j_align(img, pts, DEFAULT_BASE_PTS, (224, 224, 3)))
    got = align(torch.from_numpy(img), pts, DEFAULT_BASE_PTS, (224, 224, 3))
    assert tuple(got.shape) == (224, 224, 3)
    np.testing.assert_allclose(got.numpy() / 255.0, want / 255.0, rtol=0, atol=1e-3)


def test_plain_warp_of_a_degenerate_map_is_nan_not_an_error():
    """A map with NaNs (a failed solve): the plain K1, like the kernel, reads
    index 0 for a NaN sample position and returns a NaN crop, which the
    pipelines' validity masks out, instead of raising."""
    img = torch.rand(2, 32, 32, 3)
    Hs = torch.eye(3).repeat(2, 1, 1)
    Hs[1, 0, 0] = float("nan")
    out = warp_perspective_batch(img, Hs, (16, 16))
    assert torch.isnan(out[1]).all()
    torch.testing.assert_close(out[0], img[0, :16, :16], rtol=0, atol=0)


@pytest.fixture(scope="module")
def chains(models, tmp_path_factory):
    """The JAX chain (``generate_tsv_to_reproduce1.prepare_data`` with JAX
    ``Preproc3`` closures, photos read by PIL) and the port's
    (``generate_tsv.prepare_data``, photos read by ``native``) on one split."""
    root = tmp_path_factory.mktemp("kashtanka")
    data = make_smoke_datasets.make_kashtanka_test(root, n_pairs=2, n_extra=1, n_imgs=1)
    j_pre = JPreproc3(model_fn=models["det_fn"], thr=0.0)

    def j_head(img, animal_type):
        try:
            aligned = j_pre(img)
        except (AssertionError, ValueError, OSError):
            return None
        return np.asarray(models["j_fes"][animal_type](jnp.asarray(aligned[None]) / 255.0))[0]

    j_db = j_generate.prepare_data(data, j_head, None)
    mp = pytest.MonkeyPatch()
    mp.setenv("PFR_RETRIEVAL_THR", "0.0")
    try:
        head = build_head_pipeline(models["det"], models["dog"], models["cat"], device="cpu")
    finally:
        mp.undo()
    db = generate_tsv.prepare_data(data, head)
    return data, j_db, db


def test_chain_keeps_the_jax_chains_images(chains):
    """The same cards with the same number of valid photos each."""
    _, j_db, db = chains
    assert list(db) == list(j_db)
    for key in db:
        for got, want in zip(db[key], j_db[key]):
            assert [(c.name, c.type, len(c.head_vectors)) for c in got] == \
                [(c.name, c.type, len(c.head_vectors)) for c in want]


def test_chain_scores_and_tsv_match_jax(chains, tmp_path, monkeypatch):
    """The same queries in the same order, and the near-tie contract between
    the two score dumps. Budgets: score drift and the score gap of any
    inverted pair <= 1e-4, the card's budget against the CPU. The JAX
    chain's cv2 crops may differ from the port's exact ones by up to 8
    levels (see the crop test) but differ by far less on average, and a
    score is a mean of cosines of whole crops' embeddings."""
    _, j_db, db = chains
    j_dump_path = tmp_path / "jax.npz"
    monkeypatch.setenv("PFR_SCORES_DUMP", str(j_dump_path))
    jr._SCORES_DUMP.clear()
    try:
        j_rows = jr.create_table(j_db)
        jr.write_tsv(j_rows, tmp_path / "jax.tsv")
    finally:
        jr._SCORES_DUMP.clear()
    dump = {}
    rows = retrieval.create_table(db, "cpu", dump)
    retrieval.write_tsv(rows, tmp_path / "port.tsv")
    assert [r[0] for r in rows] == list(j_rows["query"])
    assert len(rows) >= 2
    report = retrieval.near_tie_report(retrieval.load_scores_dump(j_dump_path), dump)
    assert not (report["only_a"] or report["only_b"] or report["gallery_only_a"]
                or report["gallery_only_b"]), report
    assert report["max_score_drift"] <= 1e-4, report
    assert report["max_flip_float_gap"] <= 1e-4, report
    header = (tmp_path / "port.tsv").read_text().splitlines()[0]
    assert header == (tmp_path / "jax.tsv").read_text().splitlines()[0]


def test_generate_tsv_main_writes_the_tsv_and_dump(chains, tmp_path, monkeypatch):
    """The entry point end to end on the CPU, its models cut to one block a
    stage (seeded random weights): a tsv with the JAX header, every query a
    row, stock rows backfilled, the dump written, the DB cache read back."""
    data = chains[0]
    stock = tmp_path / "stock.tsv"
    stock.write_text("query\tmatched_1\tmatched_3\tmatched_10\tanswer\nstock_q\t0.50\t\t\t\n")
    monkeypatch.setenv("PFR_RETRIEVAL_THR", "0.0")
    monkeypatch.setenv("PFR_SCORES_DUMP", str(tmp_path / "dump.npz"))
    out, cache = tmp_path / "out" / "pred.tsv", tmp_path / "db.pickle"
    args = ["--data", str(data), "--output", str(out), "--stock-preds", str(stock),
            "--cache", str(cache), "--device", "cpu"]
    monkeypatch.setattr(generate_tsv, "build_retrieval_models", lambda dev, seed, arch: (
        weights.init_random_(keypointrcnn_resnet50_fpn(
            stage_sizes=STAGES, rpn_pre_nms_top_n_test=PRE, rpn_post_nms_top_n_test=POST),
            seed).eval(),
        weights.init_random_(resnet50_embedder(512, stage_sizes=STAGES), seed + 1).eval(),
        weights.init_random_(resnet50_embedder(512, stage_sizes=STAGES), seed + 2).eval()))
    assert generate_tsv.main(args) == 0
    lines = out.read_text().splitlines()
    assert lines[0] == "query\tmatched_1\tmatched_3\tmatched_10\tanswer"
    assert lines[-1] == "stock_q\t0.5\t\t\t"
    assert cache.exists() and len(retrieval.load_scores_dump(tmp_path / "dump.npz")) == \
        len(lines) - 2
    first = out.read_text()
    assert generate_tsv.main(args) == 0   # from the cache
    assert out.read_text() == first


def test_generate_tsv_reads_the_packaged_corpus_by_default():
    """Without ``--data`` the entry point reads the miniature split committed
    inside the package, never a folder beside its checkout."""
    pkg = Path(generate_tsv.__file__).resolve().parent
    assert generate_tsv.DEFAULT_DATA.is_relative_to(pkg)
    assert (generate_tsv.DEFAULT_DATA / "found").is_dir()
    assert (generate_tsv.DEFAULT_DATA / "lost").is_dir()
