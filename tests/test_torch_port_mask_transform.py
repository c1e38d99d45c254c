"""The port's masked corpus transform (``transform_reproduce --stages
masked``, ``transform_dataset --pipeline body|head_bbox``) and
``prepare_tables`` against the JAX package's scripts on the CPU.

The masked route runs over the ``make_data25`` and ``make_petfinder_extras``
layouts (320 x 320 photos, so both letterboxes are exact) with one Mask
R-CNN's weights on both sides (cut to one block a stage at production
widths, its mask logits spread so that the 0.7 threshold cuts inside the
masks), at detection threshold 0: the same files under the same names, each
holding the same pixels (the masked crops are whole-pixel copies).

The tables are compared twice: byte for byte on detections that both sides
take from one seeded list (a stand-in detector, call by call, so the
pipelines and the writers are compared, not the detectors' last bits), and
on the shared-weight detectors, parsed: the same rows, boxes and landmarks,
scores within 1e-5.
"""

import ast
import csv
import importlib
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pets_face_recognition_tpu import preprocessor as j_pre
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu_torch import (native, pipelines, prepare_tables, smoke_data,
                                             transform_dataset, transform_reproduce, weights)
from pets_face_recognition_tpu_torch import preprocessor as pre
from pets_face_recognition_tpu_torch.models import rcnn

from test_torch_port_models import randomize

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
j_transform = importlib.import_module("transform_reproduce")
j_tables = importlib.import_module("prepare_tables")

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
PRE, POST = 64, 32
SERVE = 8
OUTPUTS = ("data_25_transformed_v4_masked_dogs", "data_25_transformed_v4_masked_cats",
           "petfinder_extra_dogs_transformed_v4_masked",
           "petfinder_extra_cats_transformed_v4_masked")


def _backbone():
    return j_fpn.BackboneWithFPN(backbone=j_resnet.ResNet(
        stage_sizes=STAGES, features_only=True, frozen_stats=True))


@pytest.fixture(scope="module")
def detectors():
    rng = np.random.RandomState(61)
    budgets = dict(rpn_pre_nms_top_n_test=PRE, rpn_post_nms_top_n_test=POST)
    x = jnp.zeros((1, 320, 320, 3))
    j_mask = j_rcnn.GeneralizedRCNN(backbone=_backbone(), cfg=j_rcnn.RCNNConfig(
        num_classes=2, with_mask=True, box_detections_per_img=3, **budgets))
    j_kp = j_rcnn.GeneralizedRCNN(backbone=_backbone(), cfg=j_rcnn.RCNNConfig(
        num_classes=2, num_keypoints=3, box_detections_per_img=1, **budgets))
    mask_vars = randomize(jax.eval_shape(j_mask.init, jax.random.PRNGKey(0), x), rng)
    logits = mask_vars["params"]["mask_head"]["mask_fcn_logits"]
    logits["kernel"] = logits["kernel"] * 30.0
    kp_vars = randomize(jax.eval_shape(j_kp.init, jax.random.PRNGKey(1), x), rng)
    mask = rcnn.maskrcnn_resnet50_fpn(stage_sizes=STAGES, **budgets)
    kp = rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES, **budgets)
    for m, v in ((mask, mask_vars), (kp, kp_vars)):
        m.load_state_dict(weights.to_tensors(weights.detection_state_dict(v)), strict=True)
        m.eval()
    return dict(j_mask=jax.jit(lambda v: j_mask.apply(mask_vars, v)),
                j_kp=jax.jit(lambda v: j_kp.apply(kp_vars, v)), mask=mask, kp=kp)


@pytest.fixture(scope="module")
def masked_runs(detectors, tmp_path_factory):
    root = tmp_path_factory.mktemp("masked")
    smoke_data.make_data25(root / "jax", n_cards=4, n_imgs=2)
    smoke_data.make_petfinder_extras(root / "jax", n_cards=2)
    shutil.copytree(root / "jax", root / "port")
    saved = j_transform.DATA_ROOT, j_transform.v
    j_transform.DATA_ROOT, j_transform.v = root / "jax", "v4_masked"
    try:
        j4 = j_pre.Preproc4(model_fn=detectors["j_mask"], thr=0.0, use_mask=True,
                            mask_thr=0.7, serve_batch=SERVE)
        j_transform.extra_petfinder(j4, "dog")
        j_transform.data_25(j4, 1)
        j_transform.data_25(j4, 2)
        j_transform.extra_petfinder(j4, "cat")
    finally:
        j_transform.DATA_ROOT, j_transform.v = saved
    p4 = pre.Preproc4(detectors["mask"], thr=0.0, use_mask=True, mask_thr=0.7,
                      serve_batch=SERVE, device="cpu")
    written = transform_reproduce.masked(p4, data_root=root / "port")
    again = transform_reproduce.masked(p4, data_root=root / "port")
    return dict(root=root, written=written, again=again)


def _outputs(base: Path) -> list[str]:
    return sorted(str(p.relative_to(base)) for d in OUTPUTS for p in (base / d).rglob("*")
                  if p.is_file())


def test_masked_transform_writes_the_jax_files(masked_runs):
    """The same file names (exclusions, suffixes, the ``v4_masked`` folders),
    each file decoding to the same pixels as JAX's (a JPEG byte for byte:
    the port's libjpeg encoder writes PIL's bytes); a second run writes
    nothing."""
    root = masked_runs["root"]
    got, want = _outputs(root / "port"), _outputs(root / "jax")
    assert got == want and len(got) >= 12
    assert sorted(str(p.relative_to(root / "port")) for p in masked_runs["written"]) == got
    assert masked_runs["again"] == []
    tightened = 0
    for rel in got:
        a, b = root / "port" / rel, root / "jax" / rel
        pixels = np.asarray(Image.open(a))
        np.testing.assert_array_equal(pixels, np.asarray(Image.open(b)), err_msg=rel)
        np.testing.assert_array_equal(native.read_rgb(a), pixels, err_msg=rel)
        if rel.endswith(".jpg") and native.route() == "libjpeg":
            assert a.read_bytes() == b.read_bytes(), rel
        tightened += int(pixels.shape[0] * pixels.shape[1] < 320 * 320)
    assert tightened > 0


def test_transform_reproduce_main_masked(detectors, tmp_path, monkeypatch):
    """``main(["--stages", "masked"])`` builds ``Preproc4(use_mask=True,
    mask_thr=0.7)`` over ``pipelines.mask_detector`` and writes the four
    ``v4_masked`` corpora; an unknown stage raises."""
    smoke_data.make_data25(tmp_path, n_cards=2, n_imgs=1)
    smoke_data.make_petfinder_extras(tmp_path, n_cards=1, n_imgs=1)
    built = []
    monkeypatch.setattr(transform_reproduce, "mask_detector",
                        lambda dev: built.append(dev) or detectors["mask"])
    monkeypatch.setattr(pre.Preproc4, "__init__", _thr0(pre.Preproc4.__init__))
    written = transform_reproduce.main(["--data-root", str(tmp_path), "--stages", "masked",
                                        "--device", "cpu", "--batch-size", "4"])
    assert len(built) == 1 and written
    assert {p.relative_to(tmp_path).parts[0] for p in written} <= set(OUTPUTS)
    with pytest.raises(ValueError):
        transform_reproduce.main(["--data-root", str(tmp_path), "--stages", "bodies",
                                  "--device", "cpu"])


def _thr0(init):
    """``init`` with the detection threshold forced to 0 (random weights)."""
    def wrapped(self, *a, **k):
        init(self, *a, **k)
        self.thr = 0.0
    return wrapped


@pytest.mark.parametrize("pipeline,extra", [("body", []), ("body", ["--masked"]),
                                            ("head_bbox", [])])
def test_transform_dataset_body_and_head_bbox(detectors, tmp_path, monkeypatch, pipeline,
                                              extra):
    """``transform_dataset --pipeline body|head_bbox`` writes each kept
    photo's crop of ``Preproc4`` (Mask R-CNN, ``--masked``) or ``Preproc6``
    (the keypoint detector's box) under the same relative name."""
    src = smoke_data.make_data25(tmp_path / "in", n_cards=1, n_imgs=2)
    monkeypatch.setattr(transform_dataset, "mask_detector", lambda dev: detectors["mask"])
    monkeypatch.setattr(transform_dataset, "keypoint_detector", lambda dev: detectors["kp"])
    written = transform_dataset.main(["--input", str(src), "--output", str(tmp_path / "out"),
                                      "--pipeline", pipeline, "--thr", "0", "--device", "cpu",
                                      "--batch-size", "4", *extra])
    assert written
    cls = pre.Preproc6 if pipeline == "head_bbox" else pre.Preproc4
    det = detectors["kp"] if pipeline == "head_bbox" else detectors["mask"]
    kw = {} if pipeline == "head_bbox" else dict(use_mask=bool(extra), mask_thr=0.5)
    p = cls(det, thr=0.0, device="cpu", **kw)
    for path in written:
        crop = p(native.read_rgb(src / path.relative_to(tmp_path / "out"))).numpy()
        crop = np.clip(crop, 0, 255).astype(np.uint8)
        got = native.read_rgb(path)
        assert got.shape == crop.shape
        if path.suffix == ".png":
            np.testing.assert_array_equal(got, crop)


# --------------------------------------------------------------------------- #
# prepare_tables
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def table_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("labeled")
    smoke_data.make_data25(root, n_cards=2, n_imgs=1)
    smoke_data.make_petfinder_extras(root, n_cards=1, n_imgs=1)
    (root / "data_25" / "rl131336" / "broken.jpg").write_bytes(b"not a photo")
    return root


class Scripted:
    """Detections from one seeded list, the next one at each call, as a JAX
    ``model_fn`` (numpy in, arrays out) and as a port detector module."""

    def __init__(self, seed: int, keypoints: bool):
        self.rng = np.random.RandomState(seed)
        self.keypoints = keypoints
        self.calls = 0

    def next(self) -> dict[str, np.ndarray]:
        r = self.rng
        D = 1 if self.keypoints else 3
        xy = r.uniform(0, 250, (1, D, 2)).astype(np.float32)
        boxes = np.concatenate([xy, xy + r.uniform(-5, 120, (1, D, 2))], -1).astype(np.float32)
        out = dict(boxes=boxes, scores=r.uniform(0, 1, (1, D)).astype(np.float32),
                   valid=r.uniform(size=(1, D)) > 0.2, labels=np.ones((1, D), np.int32))
        if self.keypoints:
            kps = xy[:, :, None, :] + r.uniform(0, 60, (1, 1, 3, 2)).astype(np.float32)
            out["keypoints"] = np.concatenate([kps, np.ones((1, 1, 3, 1), np.float32)], -1)
            out["keypoints_scores"] = np.ones((1, 1, 3), np.float32)
        else:
            out["masks"] = r.uniform(0, 1, (1, D, 28, 28)).astype(np.float32) ** 3
        self.calls += 1
        return out

    def jax_fn(self, x):
        return {k: jnp.asarray(v) for k, v in self.next().items()}

    def module(self):
        outer = self

        class Module(torch.nn.Module):
            def forward(self, x):
                return {k: torch.from_numpy(v) for k, v in outer.next().items()}
        return Module()


def _pipelines(side: str, kp, mask):
    P = j_pre if side == "jax" else pre
    key = "model_fn" if side == "jax" else "model"
    dev = {} if side == "jax" else {"device": "cpu"}
    base = j_tables.BASE_PTS if side == "jax" else prepare_tables.BASE_PTS
    return (P.Preproc3(**{key: kp}, thr=0.5, base_pts=base, dsize=(224, 224, 3), **dev),
            P.Preproc4(**{key: mask}, thr=0.5, use_mask=True, mask_thr=0.7, **dev),
            P.Preproc6(**{key: kp}, thr=0.5, **dev))


NAMES = ("landmark.tsv", "detected_body.tsv", "detected_head.tsv")


def test_prepare_tables_are_byte_equal_to_pandas(table_root, tmp_path):
    """The three tables byte for byte as the JAX script's pandas writes them,
    on the same detections call by call: the walk, the silent skips (score
    below the threshold, an empty crop or mask, a file that does not
    decode), the rounded landmarks and boxes, the tightened body boxes and
    the plain-float score lists."""
    for i, name in enumerate(NAMES):
        outs = {}
        for side in ("jax", "port"):
            kp, mask = Scripted(70 + i, True), Scripted(80 + i, False)
            fn = (lambda s: s.jax_fn) if side == "jax" else (lambda s: s.module())
            p = _pipelines(side, fn(kp), fn(mask))[i]
            (tmp_path / side).mkdir(exist_ok=True)
            outs[side] = tmp_path / side / name
            if side == "jax":
                j_tables.prepare_table(p, table_root, str(outs[side]))
            else:
                assert prepare_tables.prepare_table(p, table_root, outs[side]) == outs[side]
        text = outs["port"].read_text()
        assert len(text.splitlines()) >= 4, text
        assert outs["port"].read_bytes() == outs["jax"].read_bytes(), name


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="\t"))


def test_prepare_tables_on_shared_detectors(detectors, table_root, tmp_path):
    """The tables of the shared-weight detectors (threshold 0): the same
    photos and columns, equal landmarks and boxes, scores within 1e-5."""
    for i, name in enumerate(NAMES):
        j_p = _pipelines("jax", detectors["j_kp"], detectors["j_mask"])[i]
        p = _pipelines("port", detectors["kp"], detectors["mask"])[i]
        j_p.thr = p.thr = 0.0
        j_tables.prepare_table(j_p, table_root, str(tmp_path / f"jax_{name}"))
        prepare_tables.prepare_table(p, table_root, tmp_path / f"port_{name}")
        got, want = _read(tmp_path / f"port_{name}"), _read(tmp_path / f"jax_{name}")
        assert len(got) == len(want) >= 6
        for g, w in zip(got, want):
            assert g[0] == w[0]
            if name == "landmark.tsv" or g[0] == "query":
                assert g == w
                continue
            assert g[1] == w[1]
            np.testing.assert_allclose(ast.literal_eval(g[2]), ast.literal_eval(w[2]),
                                       rtol=0, atol=1e-5)


def test_prepare_tables_main(detectors, table_root, tmp_path, monkeypatch):
    """``main`` writes the three tables under ``--out-dir`` from the two
    detectors of ``pipelines``."""
    monkeypatch.setattr(prepare_tables, "keypoint_detector", lambda dev: detectors["kp"])
    monkeypatch.setattr(prepare_tables, "mask_detector", lambda dev: detectors["mask"])
    written = prepare_tables.main(["--data", str(table_root), "--thr", "0",
                                   "--out-dir", str(tmp_path), "--device", "cpu"])
    assert [p.name for p in written] == list(NAMES)
    assert all(len(_read(p)) >= 6 for p in written)


def test_mask_detector_checkpoint_resolution(tmp_path, monkeypatch):
    """``PFR_MASK_CKPT`` naming no checkpoint raises; a folder gives its
    newest ``epoch=*-step=*``, loaded strictly."""
    monkeypatch.setenv("PFR_MASK_CKPT", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        pipelines.mask_detector("cpu")
    from pets_face_recognition_tpu_torch.engine import checkpoint

    model = rcnn.maskrcnn_resnet50_fpn()
    sd = {k: torch.full_like(v, 0.5) if v.is_floating_point() else v
          for k, v in model.state_dict().items()}
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    monkeypatch.setattr(checkpoint, "load_params",
                        lambda p: (seen.append(p.name), sd)[1])
    for name in ("epoch=0-step=2", "epoch=1-step=10", "epoch=1-step=9"):
        (ckpts / name).write_bytes(b"")
    seen = []
    monkeypatch.setenv("PFR_MASK_CKPT", str(ckpts))
    det = pipelines.mask_detector("cpu")
    assert seen == ["epoch=1-step=10"]
    assert float(det.roi_heads.mask_predictor.mask_fcn_logits.bias[0]) == 0.5
