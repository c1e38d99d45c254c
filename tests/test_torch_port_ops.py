"""Port ops against the JAX package on the CPU: boxes, anchors, NMS (plain K2),
RoIAlign (plain K3) and the warp (plain K1), on the same numpy inputs.

JAX runs as its own tests run it here: the gather / vmapped reference paths,
and the Pallas kernels in ``interpret=True``. Tolerances are float32 and say
why they are not 0 where they are not.
"""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pets_face_recognition_tpu.ops import anchors as j_anchors
from pets_face_recognition_tpu.ops import boxes as j_boxes
from pets_face_recognition_tpu.ops import homography as j_hom
from pets_face_recognition_tpu.ops.pallas_nms import nms_keep_sorted_batch as j_nms_pallas
from pets_face_recognition_tpu.ops.pallas_roi_align import multilevel_roi_align_pallas
from pets_face_recognition_tpu.ops.pallas_warp import warp_affine_batch_pallas
from pets_face_recognition_tpu_torch import kernels
from pets_face_recognition_tpu_torch.kernels import _build
from pets_face_recognition_tpu_torch.ops import anchors, boxes, homography, nms, roi_align

torch.set_num_threads(1)

# the JAX ops package re-exports functions under these module names
j_nms = importlib.import_module("pets_face_recognition_tpu.ops.nms")
j_roi = importlib.import_module("pets_face_recognition_tpu.ops.roi_align")

BASE = np.array([[70.0, 92.0], [154.0, 92.0], [112.0, 160.0]], np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x)


def _rand_boxes(rng, n, size=60.0, min_wh=5.0):
    xy = rng.uniform(0, size, (n, 2)).astype(np.float32)
    wh = rng.uniform(min_wh, size / 2, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], axis=1)


# float32 element-wise ops in both frameworks; XLA may contract a*b+c into an
# FMA, which moves the last bit
ELEMENTWISE = dict(rtol=1e-6, atol=1e-5)


def test_box_ops_match_jax(rng):
    a, b = _rand_boxes(rng, 12), _rand_boxes(rng, 7)
    a[3] = [5, 5, 5, 9]  # zero-area box: union guard
    np.testing.assert_allclose(boxes.area(_t(a)), _np(j_boxes.area(jnp.asarray(a))),
                               **ELEMENTWISE)
    np.testing.assert_allclose(boxes.pairwise_iou(_t(a), _t(b)),
                               _np(j_boxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b))),
                               **ELEMENTWISE)
    big = a * 3 - 20
    np.testing.assert_array_equal(boxes.clip_boxes(_t(big), (64, 48)),
                                  _np(j_boxes.clip_boxes(jnp.asarray(big), (64, 48))))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_box_coder_matches_jax(rng, weights):
    anc, gt = _rand_boxes(rng, 20), _rand_boxes(rng, 20)
    deltas = rng.randn(20, 4).astype(np.float32) * 2
    deltas[0, 2:] = 50.0  # past the log(1000/16) clamp
    np.testing.assert_allclose(
        boxes.encode_boxes(_t(gt), _t(anc), weights),
        _np(j_boxes.encode_boxes(jnp.asarray(gt), jnp.asarray(anc), weights)), **ELEMENTWISE)
    np.testing.assert_allclose(
        boxes.decode_boxes(_t(deltas), _t(anc), weights),
        _np(j_boxes.decode_boxes(jnp.asarray(deltas), jnp.asarray(anc), weights)),
        rtol=1e-5, atol=1e-3)  # exp of ~4 amplifies the last-bit FMA difference


def test_multilevel_anchors_match_jax():
    sizes = [(8, 8), (4, 4), (2, 2)]
    strides = [4, 8, 16]
    per_level = ((32,), (64,), (128,))
    got = anchors.multilevel_anchors(sizes, strides, per_level)
    want = _np(j_anchors.multilevel_anchors(sizes, strides, per_level))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,thr", [(0, 0.5), (1, 0.7), (2, 0.3)])
def test_nms_index_form_matches_jax(seed, thr):
    rng = np.random.RandomState(seed)
    bx = _rand_boxes(rng, 64)
    scores = rng.uniform(0, 1, 64).astype(np.float32)
    valid = rng.uniform(size=64) > 0.2
    idx, ok = nms.nms(_t(bx), _t(scores), thr, 20, valid=_t(valid))
    j_idx, j_ok = j_nms.nms(jnp.asarray(bx), jnp.asarray(scores), thr, 20,
                            valid=jnp.asarray(valid))
    np.testing.assert_array_equal(ok, _np(j_ok))
    np.testing.assert_array_equal(idx.numpy()[ok.numpy()], _np(j_idx)[_np(j_ok)])


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_keep_sorted_batch_matches_pallas_interpret(seed):
    """Plain K2 keep masks equal the Pallas kernel's, bit for bit."""
    rng = np.random.RandomState(seed)
    G, K = 4, 48
    bx = np.stack([_rand_boxes(rng, K) for _ in range(G)])
    bx[0, 5] = bx[0, 2]  # exact duplicate: iou 1
    valid = rng.uniform(size=(G, K)) > 0.15
    got = nms.nms_keep_sorted_batch(_t(bx), _t(valid), 0.7)
    want = _np(j_nms_pallas(jnp.asarray(bx), jnp.asarray(valid), 0.7, interpret=True)) > 0
    np.testing.assert_array_equal(got.numpy(), want)


def _pyramid(rng, B=2, C=8, sizes=(32, 16, 8, 4)):
    return [rng.randn(B, s, s, C).astype(np.float32) for s in sizes]


def _mixed_rois(rng, B, per_image, image=128.0):
    """Level-spread RoIs plus ones overhanging the image, 5:1 wide ones and a
    zero-area one."""
    rois, bidx = [], []
    for b in range(B):
        for i in range(per_image):
            size = 16 * 2 ** rng.uniform(0, 4)
            aspect = 5.0 if i % 4 == 0 else rng.uniform(0.5, 2.0)
            w, h = size * np.sqrt(aspect), size / np.sqrt(aspect)
            cx, cy = rng.uniform(-10, image + 10, 2)
            rois.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
            bidx.append(b)
    rois[1] = [30.0, 30.0, 30.0, 40.0]
    return np.asarray(rois, np.float32), np.asarray(bidx, np.int32)


def test_roi_levels_match_jax(rng):
    rois, _ = _mixed_rois(rng, 1, 24)
    # exact power-of-two sizes sit on the mapper's boundaries
    edge = np.array([[0, 0, 112, 112], [0, 0, 224, 224], [0, 0, 448, 448],
                     [0, 0, 56, 56], [3, 3, 3, 3]], np.float32)
    rois = np.concatenate([rois, edge])
    np.testing.assert_array_equal(roi_align.roi_levels(_t(rois), 2, 5),
                                  _np(j_roi.roi_levels(jnp.asarray(rois), 2, 5)))


@pytest.mark.parametrize("out", [7, 14])
def test_roi_align_plain_matches_jax_gather(rng, out):
    feats = _pyramid(rng)
    rois, bidx = _mixed_rois(rng, 2, 8)
    strides = (4, 8, 16, 32)
    got = roi_align.multilevel_roi_align([_t(f) for f in feats], _t(rois), _t(bidx),
                                         (out, out), strides)
    want = _np(j_roi.multilevel_roi_align([jnp.asarray(f) for f in feats],
                                          jnp.asarray(rois), jnp.asarray(bidx),
                                          (out, out), strides))
    # same gather and arithmetic; the 2x2 mean may sum in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_roi_align_plain_matches_pallas_interpret(rng):
    """On RoIs that fit the Pallas kernel's windows (aspect <= 2, inside the
    image), at float32: the tolerance is the JAX package's own for its kernel."""
    feats = _pyramid(rng, C=16, sizes=(40, 20, 10, 5))
    rois, bidx = [], []
    for b in range(2):
        for _ in range(8):
            k = rng.randint(2, 6)
            s = min(224.0 * 2.0 ** (k - 4) * rng.uniform(1.0, 1.9), 144.0)
            ar = rng.uniform(0.6, 1.6)
            w, h = s * np.sqrt(ar), s / np.sqrt(ar)
            x1, y1 = rng.uniform(0, max(160 - w, 1)), rng.uniform(0, max(160 - h, 1))
            rois.append([x1, y1, x1 + w, y1 + h])
            bidx.append(b)
    rois, bidx = np.asarray(rois, np.float32), np.asarray(bidx, np.int32)
    strides = (4, 8, 16, 32)
    got = roi_align.multilevel_roi_align([_t(f) for f in feats], _t(rois), _t(bidx),
                                         (7, 7), strides)
    want = _np(multilevel_roi_align_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(bidx), (7, 7),
        strides, interpret=True, compute_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)


def _alignment_landmarks(rng, B, image):
    """Seeded similarity transforms of the base points inside the image."""
    out = []
    for _ in range(B):
        s = rng.uniform(0.25, 0.45) * image / 224
        th = rng.uniform(-0.3, 0.3)
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        c = image / 2 + rng.uniform(-image / 8, image / 8, 2)
        out.append((BASE - BASE.mean(0)) @ R.T * s * 224 / 100 + c)
    return np.round(np.asarray(out, np.float32))


def test_solve_homography_matches_jax(rng):
    src = _alignment_landmarks(rng, 3, 96)
    src4 = np.concatenate([np.round(src.mean(1, keepdims=True)), src], 1)
    dst4 = np.broadcast_to(np.concatenate([np.round(BASE.mean(0, keepdims=True)), BASE]),
                           (3, 4, 2)).copy()
    got = homography.solve_homography(_t(src4), _t(dst4))
    want = _np(j_hom.solve_homography(jnp.asarray(src4), jnp.asarray(dst4)))
    # two LU solvers in float32 on a Hartley-normalised 8x8 system
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_warp_plain_matches_jax_warp_perspective(rng):
    imgs = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    lms = _alignment_landmarks(rng, 2, 64)
    Hs = homography.alignment_homographies(_t(lms), _t(BASE * 32 / 224))
    got = homography.warp_perspective_batch(_t(imgs), Hs, (32, 32))
    for b in range(2):
        want = _np(j_hom.warp_perspective(jnp.asarray(imgs[b]), jnp.asarray(Hs[b].numpy()),
                                          (32, 32)))
        # H^-1 from two float32 inverses: the sample positions move by ~1e-5 px
        np.testing.assert_allclose(got[b].numpy(), want, atol=1e-4)
    one = homography.warp_perspective(_t(imgs[0]), Hs[0], (32, 32))
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())


def test_align_crop_matches_jax(rng):
    imgs = rng.uniform(0, 1, (3, 96, 96, 3)).astype(np.float32)
    lms = _alignment_landmarks(rng, 3, 96)
    base = BASE * 48 / 224
    got = homography.align_crop(_t(imgs), _t(lms), _t(base), (48, 48))
    want = _np(j_hom.align_crop(jnp.asarray(imgs), jnp.asarray(lms), jnp.asarray(base),
                                (48, 48)))
    # the homographies agree to ~1e-6 relative (two LU solves); at the crop
    # corners that moves a sample by up to ~1e-3 px on a [0, 1] noise image
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_warp_plain_matches_pallas_interpret(rng):
    """Near-affine alignment maps, as the Pallas kernel's CONTRACT requires; the
    tolerance is the JAX package's own for that kernel (0-255 pixels)."""
    imgs = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    lms = _alignment_landmarks(rng, 2, 64)
    Hs = homography.alignment_homographies(_t(lms), _t(BASE * 32 / 224))
    got = homography.warp_perspective_batch(_t(imgs), Hs, (32, 32))
    want = _np(warp_affine_batch_pallas(jnp.asarray(imgs), jnp.asarray(Hs.numpy()),
                                        (32, 32), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-2)


def test_cuda_wrappers_take_the_plain_version_on_cpu_tensors(rng):
    kernels.reset_launch_counts()
    imgs = _t(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    Hs = torch.eye(3).expand(2, 3, 3) * torch.tensor([1.5, 1.5, 1.0])[:, None]
    np.testing.assert_array_equal(homography.warp_perspective_batch_cuda(imgs, Hs, (16, 16)),
                                  homography.warp_perspective_batch(imgs, Hs, (16, 16)))
    bx = _t(np.stack([_rand_boxes(rng, 16)] * 2))
    v = torch.ones(2, 16, dtype=torch.bool)
    np.testing.assert_array_equal(nms.nms_keep_sorted_batch_cuda(bx, v, 0.5),
                                  nms.nms_keep_sorted_batch(bx, v, 0.5))
    feats = [_t(f) for f in _pyramid(rng)]
    rois, bidx = _mixed_rois(rng, 2, 3)
    args = (feats, _t(rois), _t(bidx), (7, 7), (4, 8, 16, 32))
    np.testing.assert_array_equal(roi_align.multilevel_roi_align_cuda(*args),
                                  roi_align.multilevel_roi_align(*args))
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}


def test_cuda_wrappers_have_no_fallback(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises; it never
    reaches the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def plain_called(*a, **k):
        raise AssertionError("plain version reached from a non-CPU tensor")

    monkeypatch.setattr(nms, "nms_keep_sorted_batch", plain_called)
    monkeypatch.setattr(roi_align, "multilevel_roi_align", plain_called)
    monkeypatch.setattr(homography, "warp_perspective_batch", plain_called)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        nms.nms_keep_sorted_batch_cuda(torch.empty(2, 8, 4, **meta),
                                       torch.empty(2, 8, dtype=torch.bool, **meta), 0.7)
    with pytest.raises(ValueError, match="CUDA"):
        roi_align.multilevel_roi_align_cuda([torch.empty(1, 8, 8, 4, **meta)],
                                            torch.empty(3, 4, **meta),
                                            torch.zeros(3, dtype=torch.int32, **meta),
                                            (7, 7), (4,), min_level=2, max_level=2)
    with pytest.raises(ValueError, match="CUDA"):
        homography.warp_perspective_batch_cuda(torch.empty(1, 8, 8, 3, **meta),
                                               torch.empty(1, 3, 3, **meta), (4, 4))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError) as err:
        _build.build()
    msg = str(err.value)
    assert "arch=compute_90a,code=sm_90a" in msg and "nms.cu" in msg
    assert not (tmp_path / "_build").exists()
