"""The port's body pipelines against the JAX package on the CPU:
``paste_mask`` against ``paste_mask_np``, the PIL-free ``resize_with_padding``
against PIL's ``thumbnail`` + ``ImageOps.expand``, and ``Preproc4`` (with and
without the mask), ``Preproc5``, ``Preproc6`` and ``PreprocCombined`` against
JAX's pipelines.

The pipelines run twice: on one set of detector weights (Mask R-CNN and the
keypoint R-CNN cut to one block a stage at production widths, JAX variables
carried over with ``weights.py``, injected as ``model_fn``) over photos whose
letterbox to 128 is exact on both sides; and on fixed detections given to
both (a stub detector), which isolates the pipelines' own arithmetic from the
detectors' float32 differences, so that the crops must be equal bit for bit.
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageOps

from pets_face_recognition_tpu import preprocessor as j_pre
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.ops.homography import warp_perspective as j_warp_perspective
from pets_face_recognition_tpu.ops.masks import paste_mask_np
from pets_face_recognition_tpu.utils import preprocs as j_preprocs
from pets_face_recognition_tpu_torch import preprocessor as pre
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.models import rcnn
from pets_face_recognition_tpu_torch.ops.homography import alignment_homographies
from pets_face_recognition_tpu_torch.ops.masks import paste_box, paste_mask
from pets_face_recognition_tpu_torch.utils import preprocs

from test_torch_port_models import randomize

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
make_smoke_datasets = importlib.import_module("make_smoke_datasets")

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
IMG, PRE, POST = 128, 64, 32


# --------------------------------------------------------------------------- #
# paste_mask and resize_with_padding
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_paste_mask_matches_paste_mask_np(dtype):
    """Integer boxes equal and pasted values within 1e-6 (bit-equal in
    practice) over boxes inside, overhanging and outside the photo, thin and
    sub-pixel ones, in the box's own float type."""
    rng = np.random.RandomState(7)
    worst, n_int = 0.0, 0
    for _ in range(120):
        H, W = rng.randint(8, 300, 2)
        x1, y1 = rng.uniform(-40, W + 5), rng.uniform(-40, H + 5)
        bw, bh = rng.choice([0.3, 1.0, 3.0, 40.0, 400.0]) * rng.uniform(0.5, 1.5, 2)
        box = np.array([x1, y1, x1 + bw, y1 + bh], dtype)
        m = rng.rand(28, 28).astype(np.float32)
        want = paste_mask_np(m, box, H, W)
        got = paste_mask(torch.from_numpy(m), box, H, W).numpy()
        assert got.dtype == np.float32 and got.shape == (H, W)
        worst = max(worst, float(np.abs(got - want).max()))
        # the JAX integer box, in the box's own float type (numpy 2 keeps a
        # float32 box in float32: the Python scale is rounded to float32)
        scale = 30.0 / 28
        cx, w2 = (box[2] + box[0]) * 0.5, (box[2] - box[0]) * 0.5 * scale
        cy, h2 = (box[3] + box[1]) * 0.5, (box[3] - box[1]) * 0.5 * scale
        j_box = np.array([cx - w2, cy - h2, cx + w2, cy + h2], np.float64).astype(np.int64)
        np.testing.assert_array_equal(paste_box(box, 28), j_box)
        n_int += 1
    assert worst <= 1e-6, worst
    assert n_int == 120


def _pil_resize_with_padding(img, size=(256, 256)):
    return np.asarray(j_preprocs.resize_with_padding(Image.fromarray(img), size))


SHAPES = [
    (100, 80), (256, 256), (200, 255),                 # fits: no resize
    (300, 200), (400, 511), (257, 256),                # 256..512: bicubic alone
    (513, 700), (1000, 1000), (777, 1333), (1536, 2048),  # > 512: reduce first
    (3024, 4032), (2600, 300),
    (1, 600), (600, 1), (1, 1), (3, 2000), (2000, 7),  # 1 px thin, extreme aspect
] + [(512 * f + 3, 300 + 7 * f) for f in range(2, 9)]  # each reduce factor


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_with_padding_is_bit_equal_to_pil(shape):
    rng = np.random.RandomState(shape[0] * 7 + shape[1])
    noise = rng.randint(0, 256, (*shape, 3))
    smooth = np.linspace(0, 255, shape[1])[None, :, None] * np.ones((shape[0], 1, 3))
    for img in (noise, smooth):
        img = img.astype(np.uint8)
        got = preprocs.resize_with_padding(img, (256, 256))
        want = _pil_resize_with_padding(img)
        assert got.shape == want.shape == (256, 256, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,size", [((90, 60), 128), ((128, 128), 128), ((50, 200), 64)])
def test_padding_matches_pil(shape, size):
    img = np.random.RandomState(2).randint(0, 256, (*shape, 3)).astype(np.uint8)
    want = np.asarray(j_preprocs.padding(Image.fromarray(img), size))
    np.testing.assert_array_equal(preprocs.padding(img, size), want)


# --------------------------------------------------------------------------- #
# the pipelines on shared detector weights
# --------------------------------------------------------------------------- #


def _backbone():
    return j_fpn.BackboneWithFPN(backbone=j_resnet.ResNet(
        stage_sizes=STAGES, features_only=True, frozen_stats=True))


@pytest.fixture(scope="module")
def detectors():
    rng = np.random.RandomState(41)
    budgets = dict(rpn_pre_nms_top_n_test=PRE, rpn_post_nms_top_n_test=POST)
    x = jnp.zeros((1, IMG, IMG, 3))
    j_mask = j_rcnn.GeneralizedRCNN(backbone=_backbone(), cfg=j_rcnn.RCNNConfig(
        num_classes=2, with_mask=True, box_detections_per_img=3, **budgets))
    j_kp = j_rcnn.GeneralizedRCNN(backbone=_backbone(), cfg=j_rcnn.RCNNConfig(
        num_classes=2, num_keypoints=3, box_detections_per_img=1, **budgets))
    mask_vars = randomize(jax.eval_shape(j_mask.init, jax.random.PRNGKey(0), x), rng)
    kp_vars = randomize(jax.eval_shape(j_kp.init, jax.random.PRNGKey(1), x), rng)
    # random mask logits sit near 0 (probabilities near 0.5): spread them so
    # that both thresholds, 0.5 and 0.7, cut inside the masks
    logits = mask_vars["params"]["mask_head"]["mask_fcn_logits"]
    logits["kernel"] = logits["kernel"] * 30.0
    mask = rcnn.maskrcnn_resnet50_fpn(stage_sizes=STAGES, **budgets)
    kp = rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES, **budgets)
    for m, v in ((mask, mask_vars), (kp, kp_vars)):
        m.load_state_dict(weights.to_tensors(weights.detection_state_dict(v)), strict=True)
        m.eval()
    return dict(j_mask=jax.jit(lambda v: j_mask.apply(mask_vars, v)),
                j_kp=jax.jit(lambda v: j_kp.apply(kp_vars, v)), mask=mask, kp=kp)


def photos():
    """Photos whose letterbox to 128 is exact in cv2 and in PyTorch (scale 1,
    and exact 2x downscales), so both detectors see the same pixels."""
    rng = np.random.RandomState(4)
    shapes = [(128, 128), (256, 256), (256, 192), (192, 256), (128, 96)]
    return [make_smoke_datasets._pet_image(rng, size=max(s))[: s[0], : s[1]] for s in shapes]


def _np(crop):
    return None if crop is None else crop.numpy()


def _compare_crops(got_crops, got_valid, got_raw, want_crops, want_valid, want_raw):
    """Validity equal, rounded boxes equal, and crops equal on kept photos."""
    np.testing.assert_array_equal(got_valid, want_valid)
    assert want_valid.any(), "no photo kept to compare"
    for i in np.nonzero(want_valid)[0]:
        np.testing.assert_array_equal(np.round(got_raw["boxes"][i]),
                                      np.round(want_raw["boxes"][i]))
        np.testing.assert_array_equal(_np(got_crops[i]), want_crops[i].astype(np.float32))


@pytest.mark.parametrize("use_mask,mask_thr", [(False, 0.5), (True, 0.5), (True, 0.7)])
def test_preproc4_matches_jax(detectors, use_mask, mask_thr):
    """``Preproc4`` with and without the mask on the same weights: validity,
    the (tightened) boxes and the crops equal; the top scores within 1e-5,
    every detection's score too (``return_for_metrics``'s ``all_scores``)."""
    imgs = photos()
    want = j_pre.Preproc4(model_fn=detectors["j_mask"], thr=0.0, use_mask=use_mask,
                          mask_thr=mask_thr, input_size=(IMG, IMG)).batch(imgs)
    got = pre.Preproc4(detectors["mask"], thr=0.0, use_mask=use_mask, mask_thr=mask_thr,
                       input_size=(IMG, IMG), device="cpu").batch(imgs)
    _compare_crops(*got, *want)
    np.testing.assert_allclose(got[2]["all_scores"], want[2]["all_scores"], rtol=0, atol=1e-5)


def test_preproc4_call_and_return_for_metrics(detectors):
    img = photos()[1]
    j4 = j_pre.Preproc4(model_fn=detectors["j_mask"], thr=0.0, use_mask=True, mask_thr=0.5,
                        input_size=(IMG, IMG))
    p4 = pre.Preproc4(detectors["mask"], thr=0.0, masked=True, mask_thr=0.5,
                      input_size=(IMG, IMG), device="cpu")
    np.testing.assert_array_equal(p4(img).numpy(), j4(img).astype(np.float32))
    j4.return_for_metrics = p4.return_for_metrics = True
    (gb, gs), (wb, ws) = p4(img), j4(img)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    with pytest.raises(AssertionError):
        pre.Preproc4(detectors["mask"], thr=1.1, input_size=(IMG, IMG), device="cpu")(img)


def test_preproc5_matches_jax(detectors):
    """``Preproc5`` on the same weights: validity and crop shapes equal, the
    soft-masked crops within 1e-3 (on [0, 1]): the masks differ in the last
    bits, which the squared weights carry into the crops."""
    imgs = photos()
    want = j_pre.Preproc5(model_fn=detectors["j_mask"], thr=0.0, mask_thr=0.5,
                          input_size=(IMG, IMG)).batch(imgs)
    got = pre.Preproc5(detectors["mask"], thr=0.0, mask_thr=0.5, input_size=(IMG, IMG),
                       device="cpu").batch(imgs)
    np.testing.assert_array_equal(got[1], want[1])
    assert want[1].any()
    for i in np.nonzero(want[1])[0]:
        assert got[0][i].shape == want[0][i].shape
        assert np.abs(got[0][i].numpy() - want[0][i]).max() / 255.0 <= 1e-3


def test_preproc6_matches_jax(detectors):
    """``Preproc6``: the keypoint detector's head box crop."""
    imgs = photos()
    want = j_pre.Preproc6(model_fn=detectors["j_kp"], thr=0.0,
                          input_size=(IMG, IMG)).batch(imgs)
    got = pre.Preproc6(detectors["kp"], thr=0.0, input_size=(IMG, IMG),
                       device="cpu").batch(imgs)
    _compare_crops(*got, *want)


def test_preproc_combined_matches_jax(detectors):
    """``PreprocCombined``: the masked body crop, then the aligned head.
    Validity equal; where the rounded landmarks agree, the aligned crop
    within 1e-3 (on [0, 1]) of JAX's ``warp_perspective`` of the same map
    (JAX's pipeline warps with cv2, which snaps samples to 1/32 px). The
    masked crops have other shapes than 128 and the two letterboxes resample
    them in float32 (cv2 and torch), so a landmark may round to another
    pixel: at least half must agree. The random keypoint detector puts the
    landmarks of these small crops within 5 px of each other, so the distance
    rule is off (``min_distance=0``) on both sides."""
    imgs = photos()
    j_comb = j_pre.PreprocCombined(
        j_pre.Preproc3(model_fn=detectors["j_kp"], thr=0.0, min_distance=0.0,
                       input_size=(IMG, IMG)),
        j_pre.Preproc4(model_fn=detectors["j_mask"], thr=0.0, use_mask=True, mask_thr=0.5,
                       input_size=(IMG, IMG)))
    comb = pre.PreprocCombined(
        pre.Preproc3(detectors["kp"], thr=0.0, min_distance=0.0, input_size=(IMG, IMG),
                     device="cpu"),
        pre.Preproc4(detectors["mask"], thr=0.0, use_mask=True, mask_thr=0.5,
                     input_size=(IMG, IMG), device="cpu"))
    _, want_valid, want_raw = j_comb.batch(imgs)
    aligned, valid, raw = comb.batch(imgs)
    np.testing.assert_array_equal(valid, want_valid)
    masked, _, _ = comb.mask_pipeline.batch(imgs)
    same = [i for i in np.nonzero(valid)[0]
            if (raw["keypoints"][i] == want_raw["keypoints"][i]).all()]
    assert 2 * len(same) >= valid.sum() > 0
    for i in same:
        Hs = alignment_homographies(torch.from_numpy(raw["keypoints"][i:i + 1]),
                                    torch.from_numpy(pre.DEFAULT_BASE_PTS))
        ref = np.asarray(j_warp_perspective(jnp.asarray(masked[i].numpy()),
                                            jnp.asarray(Hs[0].numpy()), (224, 224)))
        ok = np.isfinite(ref)
        assert np.abs(aligned[i].numpy()[ok] - ref[ok]).max() / 255.0 <= 1e-3


# --------------------------------------------------------------------------- #
# the pipelines on fixed detections
# --------------------------------------------------------------------------- #


class FixedDetections(torch.nn.Module):
    """A detector stand-in that returns the same detections for any batch."""

    def __init__(self, dets):
        super().__init__()
        self.dets = {k: torch.from_numpy(np.asarray(v)) for k, v in dets.items()}

    def forward(self, x):
        return {k: v[: x.shape[0]] for k, v in self.dets.items()}


def fixed_detections(n):
    """``n`` photos' detections at 128 x 128: boxes inside, overhanging and
    tiny, a mask that is 0 everywhere (dropped under the mask), masks with
    values just around 0.5 and 0.7, and one invalid detection."""
    rng = np.random.RandomState(9)
    boxes = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        xy = rng.uniform(-20, 100, 2)
        boxes[i] = np.concatenate([xy, xy + rng.uniform(4, 90, 2)])[None]
    boxes[1, 0] = [10.4, 10.6, 11.2, 11.9]          # smaller than a pixel after rounding
    masks = rng.uniform(0, 1, (n, 3, 28, 28)).astype(np.float32)
    masks[2, 0] = 0.0
    masks[3, 0] = np.float32(0.5) + rng.choice([-1, 0, 1], (28, 28)) * np.float32(1e-7)
    scores = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    valid = np.ones((n, 3), bool)
    valid[4, 0] = False
    return dict(boxes=boxes, scores=scores, valid=valid, labels=np.ones((n, 3), np.int32),
                masks=masks)


def _fixed_pair(dets):
    return (lambda x: {k: jnp.asarray(v)[: x.shape[0]] for k, v in dets.items()},
            FixedDetections(dets))


@pytest.mark.parametrize("use_mask,mask_thr", [(False, 0.5), (True, 0.5), (True, 0.7)])
def test_preproc4_on_fixed_detections_is_exact(use_mask, mask_thr):
    """Validity (the all-zero mask and the empty crop drop their photos),
    boxes and crops bit-equal to JAX's on the same detections."""
    imgs = photos() + [np.full((128, 128, 3), 200, np.uint8)] * 2
    dets = fixed_detections(len(imgs))
    j_fn, stub = _fixed_pair(dets)
    want = j_pre.Preproc4(model_fn=j_fn, thr=0.0, use_mask=use_mask, mask_thr=mask_thr,
                          input_size=(IMG, IMG)).batch(imgs)
    got = pre.Preproc4(stub, thr=0.0, use_mask=use_mask, mask_thr=mask_thr,
                       input_size=(IMG, IMG), device="cpu").batch(imgs)
    np.testing.assert_array_equal(got[1], want[1])
    assert not want[1][4] and (not want[1][2] or not use_mask)
    np.testing.assert_array_equal(got[2]["boxes"], want[2]["boxes"])
    for i in np.nonzero(want[1])[0]:
        np.testing.assert_array_equal(got[0][i].numpy(), want[0][i].astype(np.float32))


def test_preproc5_on_fixed_detections_is_exact():
    """``Preproc5``'s soft-mask crops bit-equal to JAX's on the same
    detections, its uint8 ``__call__`` too."""
    imgs = photos() + [np.full((128, 128, 3), 200, np.uint8)] * 2
    dets = fixed_detections(len(imgs))
    j_fn, stub = _fixed_pair(dets)
    j5 = j_pre.Preproc5(model_fn=j_fn, thr=0.0, mask_thr=0.5, input_size=(IMG, IMG))
    p5 = pre.Preproc5(stub, thr=0.0, mask_thr=0.5, input_size=(IMG, IMG), device="cpu")
    want, got = j5.batch(imgs), p5.batch(imgs)
    np.testing.assert_array_equal(got[1], want[1])
    for i in np.nonzero(want[1])[0]:
        np.testing.assert_array_equal(got[0][i].numpy(), want[0][i])
    np.testing.assert_array_equal(p5(imgs[0]).numpy(), j5(imgs[0]))


def test_mask_threshold_flips_are_counted(detectors):
    """Pixels whose pasted value lies within float32 rounding of the mask
    threshold can cut differently on the two sides, since the detectors'
    masks differ in the last bits. Counted here on the shared-weight run
    (reported in the assertion message, not hidden): none on these photos."""
    imgs = photos()
    flips = 0
    for img in imgs:
        j_out = detectors["j_mask"](jnp.asarray(img[None, :IMG, :IMG] / 255.0, jnp.float32))
        with torch.no_grad():
            out = detectors["mask"](torch.from_numpy(img[None, :IMG, :IMG] / 255.0).float())
        box = np.asarray(j_out["boxes"])[0, 0]
        for thr in (0.5, 0.7):
            a = paste_mask_np(np.asarray(j_out["masks"])[0, 0], box.astype(np.float64),
                              IMG, IMG) > thr
            b = paste_mask(out["masks"][0, 0], box.astype(np.float64), IMG, IMG).numpy() > thr
            flips += int((a != b).sum())
    assert flips == 0, f"{flips} mask pixels cut differently"
