"""The port's differentiable RoIAlign and the NMS entry points against the JAX
package on the CPU, on the same numpy inputs: the plain RoIAlign backward (K4)
against JAX autodiff and against the Pallas backward in interpret mode, and
against PyTorch autograd through the plain forward (K3); the autograd
``Function`` that ties K3 and K4; the single-group and grid NMS entry points
(K5) against the Pallas ones; and the wrappers' refusal of non-CPU tensors
without a kernel. Tolerances say why they are not 0 where they are not.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.ops import pallas_nms as j_pallas_nms
from pets_face_recognition_tpu.ops.pallas_roi_align import multilevel_roi_align_pallas_diff
from pets_face_recognition_tpu_torch import kernels
from pets_face_recognition_tpu_torch.ops import nms, roi_align

torch.set_num_threads(1)

j_roi = importlib.import_module("pets_face_recognition_tpu.ops.roi_align")
STRIDES = (4, 8, 16, 32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pyramid(rng, B=2, C=8, sizes=(32, 16, 8, 4)):
    return [rng.randn(B, s, s, C).astype(np.float32) for s in sizes]


def _mixed_rois(rng, B, per_image, image=128.0):
    """Level-spread RoIs, ones overhanging the image, 5:1 wide ones and a
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


def _jax_roi_grads(fn, feats, rois, bidx, out, g, **kw):
    def loss(fs):
        return jnp.sum(fn(list(fs), jnp.asarray(rois), jnp.asarray(bidx), (out, out),
                          STRIDES, **kw) * jnp.asarray(g))
    grads = jax.jit(jax.grad(loss))(tuple(jnp.asarray(f) for f in feats))
    return [np.asarray(x) for x in grads]


@pytest.mark.parametrize("out", [7, 14])
def test_roi_align_backward_plain_matches_jax_autodiff(rng, out):
    """Plain K4 against ``jax.grad`` of the JAX training RoIAlign (the separable
    form at float32) and of the gather form: 1e-5 absolute (float32 sums of a
    few weighted taps in another order)."""
    feats = _pyramid(rng)
    rois, bidx = _mixed_rois(rng, 2, 8)
    g = rng.randn(len(rois), out, out, 8).astype(np.float32)
    got = roi_align.multilevel_roi_align_backward(
        _t(g), [f.shape for f in feats], _t(rois), _t(bidx), (out, out), STRIDES)
    for fn, kw in ((j_roi.multilevel_roi_align_separable, dict(compute_dtype=jnp.float32)),
                   (j_roi.multilevel_roi_align, {})):
        want = _jax_roi_grads(fn, feats, rois, bidx, out, g, **kw)
        for lvl, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0,
                                       err_msg=f"{fn.__name__} level {lvl}")


def test_roi_align_backward_plain_matches_pallas_interpret(rng):
    """Plain K4 against the Pallas custom-VJP backward in interpret mode at
    float32, on RoIs its fixed windows cover (inside the image, aspect <= 1.6):
    the JAX package's own tolerance for its kernel (5e-4 / 1e-3)."""
    B, per, C = 2, 8, 8
    feats = _pyramid(rng, B, C, sizes=(40, 20, 10, 5))
    rois, bidx = [], []
    for b in range(B):
        for _ in range(per):
            k = rng.randint(2, 6)
            s = min(224.0 * 2.0 ** (k - 4) * rng.uniform(1.0, 1.9), 144.0)
            ar = rng.uniform(0.6, 1.6)
            w, h = s * np.sqrt(ar), s / np.sqrt(ar)
            x1, y1 = rng.uniform(0, max(160 - w, 1)), rng.uniform(0, max(160 - h, 1))
            rois.append([x1, y1, x1 + w, y1 + h])
            bidx.append(b)
    rois, bidx = np.asarray(rois, np.float32), np.asarray(bidx, np.int32)
    g = rng.randn(B * per, 7, 7, C).astype(np.float32)
    got = roi_align.multilevel_roi_align_backward(
        _t(g), [f.shape for f in feats], _t(rois), _t(bidx), (7, 7), STRIDES)
    want = _jax_roi_grads(multilevel_roi_align_pallas_diff, feats, rois, bidx, 7, g,
                          interpret=True, compute_dtype=jnp.float32)
    for lvl, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), b, atol=5e-4, rtol=1e-3, err_msg=f"level {lvl}")


@pytest.mark.parametrize("out", [7, 14])
def test_roi_align_backward_plain_matches_autograd_of_plain_forward(rng, out):
    """Plain K4 against PyTorch autograd through the plain K3: the same taps and
    weights, summed by ``index_add_`` in another order: 1e-6 absolute."""
    feats = [_t(f).requires_grad_() for f in _pyramid(rng)]
    rois, bidx = _mixed_rois(rng, 2, 8)
    g = _t(rng.randn(len(rois), out, out, 8).astype(np.float32))
    fwd = roi_align.multilevel_roi_align(feats, _t(rois), _t(bidx), (out, out), STRIDES)
    want = torch.autograd.grad((fwd * g).sum(), feats)
    got = roi_align.multilevel_roi_align_backward(
        g, [f.shape for f in feats], _t(rois), _t(bidx), (out, out), STRIDES)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_multilevel_roi_align_function_wiring(rng):
    """``MultilevelRoIAlign``: the forward is the plain K3 on CPU tensors, the
    levels' gradients are the plain K4's, the RoIs get none, and no kernel is
    counted as launched."""
    kernels.reset_launch_counts()
    feats = [_t(f).requires_grad_() for f in _pyramid(rng)]
    rois, bidx = _mixed_rois(rng, 2, 4)
    rois_t = _t(rois).requires_grad_()
    g = _t(rng.randn(len(rois), 7, 7, 8).astype(np.float32))
    out = roi_align.multilevel_roi_align_diff(feats, rois_t, _t(bidx), (7, 7), STRIDES)
    np.testing.assert_array_equal(
        out.detach().numpy(),
        roi_align.multilevel_roi_align(feats, _t(rois), _t(bidx), (7, 7), STRIDES).detach())
    (out * g).sum().backward()
    assert rois_t.grad is None
    want = roi_align.multilevel_roi_align_backward(
        g, [f.shape for f in feats], _t(rois), _t(bidx), (7, 7), STRIDES)
    for f, w in zip(feats, want):
        np.testing.assert_array_equal(f.grad.numpy(), w.numpy())
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}


def _sorted_boxes(rng, G, K):
    xy = rng.uniform(0, 60, (G, K, 2)).astype(np.float32)
    wh = rng.uniform(5, 30, (G, K, 2)).astype(np.float32)
    bx = np.concatenate([xy, xy + wh], -1)
    bx[0, 5] = bx[0, 2]  # exact duplicate: iou 1
    return bx, rng.uniform(size=(G, K)) > 0.15


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_entry_points_match_pallas_interpret(seed):
    """K5's plain versions (the plain K2 on the same shapes) against the JAX
    ``nms_keep_sorted`` and ``nms_keep_sorted_grid`` in interpret mode: masks
    equal, bit for bit."""
    rng = np.random.RandomState(seed)
    bx, valid = _sorted_boxes(rng, 3, 40)
    got = nms.nms_keep_sorted(_t(bx[0]), _t(valid[0]), 0.7)
    want = np.asarray(j_pallas_nms.nms_keep_sorted(jnp.asarray(bx[0]), jnp.asarray(valid[0]),
                                                   0.7, interpret=True)) > 0
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    got = nms.nms_keep_sorted_grid(_t(bx), _t(valid), 0.7)
    want = np.asarray(j_pallas_nms.nms_keep_sorted_grid(jnp.asarray(bx), jnp.asarray(valid),
                                                        0.7, interpret=True)) > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_k4_and_k5_wrappers_have_no_fallback(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises; it never
    reaches the plain version."""
    def plain_called(*a, **k):
        raise AssertionError("plain version reached from a non-CPU tensor")

    monkeypatch.setattr(nms, "nms_keep_sorted_batch", plain_called)
    monkeypatch.setattr(roi_align, "multilevel_roi_align_backward", plain_called)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        nms.nms_keep_sorted(torch.empty(8, 4, **meta), torch.empty(8, dtype=torch.bool, **meta),
                            0.7)
    with pytest.raises(ValueError, match="CUDA"):
        nms.nms_keep_sorted_grid(torch.empty(2, 8, 4, **meta),
                                 torch.empty(2, 8, dtype=torch.bool, **meta), 0.7)
    with pytest.raises(ValueError, match="CUDA"):
        roi_align.multilevel_roi_align_backward_cuda(
            torch.empty(3, 7, 7, 4, **meta), [(1, 8, 8, 4)], torch.empty(3, 4, **meta),
            torch.zeros(3, dtype=torch.int32, **meta), (7, 7), (4,), min_level=2,
            max_level=2)


def test_nms_accepts_the_training_budget():
    """K2's guard lets the training budget through (K = 2000 boxes a group) and
    refuses only what a block's shared memory cannot hold: the sweep's two
    chunks of 64 (padded to 65) rows of ceil(K / 64) 8-byte words."""
    assert nms.NMS_MAX_K == 64 * (232448 // (2 * 65 * 8)) >= 2000
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):  # K = 2000 passes the shape guard
        nms.nms_keep_sorted_batch_cuda(torch.empty(2, 2000, 4, **meta),
                                       torch.empty(2, 2000, dtype=torch.bool, **meta), 0.7)
