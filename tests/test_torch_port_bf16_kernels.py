"""The plain versions of the port's reduced-precision kernel instances against
the JAX package's Pallas kernels in interpret mode, on the CPU: K1's bfloat16
and int8 compute modes and its bfloat16 output
(``warp_affine_batch_pallas(..., compute_dtype=, out_dtype=)``), and K3 on
bfloat16 levels (``multilevel_roi_align_pallas(..., compute_dtype=bfloat16)``)
and K4 with bfloat16 operands (the gradient of
``multilevel_roi_align_pallas_diff(..., compute_dtype=bfloat16)``).
The CUDA instances are held to these plain versions on the card
(``chip_smoke.py``); here the wrappers' CPU dispatch is checked too.

K1: the maps are near-affine alignment maps whose taps the TPU kernel's band
covers. The two packages compute the sample positions in float32 by other
formulas (the port's closed-form inverse, JAX's LU inverse normalised by its
corner), a few float32 steps apart; where a tent weight lies within that of a
rounding boundary of the mode (bfloat16's, or a multiple of 1/127), it rounds
the other way and the pixel moves by one step of that mode. So a pixel agrees
to 2e-5 (the float32 level of the positions on [0, 1] pixels), except at most
1% of them, which agree to one step: 2^-8 (one bfloat16 step of a weight or of
a bfloat16 output below 1) or 1/127 (one int8 step), plus 2e-5. Each mode is
also held to JAX's own distance from float32: int8 within 1.2e-2
(``tests/test_pallas_warp.py:88``), bfloat16 within 8e-3.

K3: both round the level values and the interpolation weights to bfloat16,
sum each column's rows and then the columns in float32, so they agree to the
float32 rounding of the 2 x 2 mean's order: 1e-5 of the value scale.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pets_face_recognition_tpu.ops.homography import solve_homography
from pets_face_recognition_tpu.ops.pallas_roi_align import (_roi_backward,
                                                             multilevel_roi_align_pallas,
                                                             multilevel_roi_align_pallas_diff)
from pets_face_recognition_tpu.ops.pallas_warp import warp_affine_batch_pallas
from pets_face_recognition_tpu_torch.ops import homography, roi_align

from test_pallas_roi_align import _level_realistic_rois, _pyramid

torch.set_num_threads(1)

S, O, B = 64, 32, 4                      # 64 x 64 images, 32 x 32 crops
BASE = np.array([[10, 13], [22, 13], [16, 23]], np.float32)
F32_LEVEL = 2e-5
MODE_STEP = {"bfloat16": 2.0 ** -8, "int8": 1.0 / 127.0}
JAX_DISTANCE = {"bfloat16": 8e-3, "int8": 1.2e-2}
MODES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
         "int8": (jnp.int8, torch.int8)}
CASES = [("bfloat16", "float32"), ("bfloat16", "bfloat16"), ("int8", "float32"),
         ("float32", "bfloat16")]


@pytest.fixture(scope="module")
def warp_case():
    rng = np.random.RandomState(0)
    imgs = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    Hs = []
    for b in range(B):
        pts = np.round(np.array([[20, 24], [40, 23 + 2 * b], [30, 38]], np.float32)
                       + rng.uniform(-3, 3, (3, 2)).astype(np.float32))
        p1 = np.concatenate([np.round(pts.mean(0, keepdims=True)), pts])
        p2 = np.concatenate([np.round(BASE.mean(0, keepdims=True)), BASE])
        Hs.append(np.asarray(solve_homography(jnp.asarray(p1), jnp.asarray(p2))))
    Hs = np.stack(Hs).astype(np.float32)
    want = {(cd, od): np.asarray(warp_affine_batch_pallas(
        jnp.asarray(imgs), jnp.asarray(Hs), (O, O), interpret=True,
        compute_dtype=MODES[cd][0], out_dtype=MODES[od][0]).astype(jnp.float32))
        for cd, od in CASES}
    return imgs, Hs, want


@pytest.mark.parametrize("mode,out", CASES)
def test_k1_modes_match_the_pallas_kernel(warp_case, mode, out):
    imgs, Hs, want = warp_case
    got = homography.warp_perspective_batch(torch.from_numpy(imgs), torch.from_numpy(Hs), (O, O),
                                            MODES[mode][1], MODES[out][1])
    assert got.dtype == MODES[out][1]
    d = np.abs(got.float().numpy() - want[mode, out])
    step = MODE_STEP["bfloat16" if mode == "float32" else mode]
    off = d > F32_LEVEL
    assert off.mean() <= 0.01, f"{off.sum()} of {d.size} pixels off the float32 level"
    assert d.max() <= step + F32_LEVEL
    if mode != "float32":
        f32 = homography.warp_perspective_batch(torch.from_numpy(imgs), torch.from_numpy(Hs),
                                                (O, O)).numpy()
        assert np.abs(got.float().numpy() - f32).max() <= JAX_DISTANCE[mode]
        assert np.abs(want[mode, out] - f32).max() <= JAX_DISTANCE[mode]


def test_k1_int8_scale_is_the_jax_constant():
    """1 / 127^2 as float32, as JAX's Python constant meets a float32 array,
    equals the correctly rounded float32 quotient the CUDA kernel folds."""
    assert np.float32(homography.INV_127_SQ) == np.float32(1) / np.float32(16129)


def test_k1_wrapper_and_align_crop_on_the_cpu(warp_case):
    """On CPU tensors the K1 wrapper runs the plain version of the mode it is
    given; ``align_crop`` warps exactly in float32 whatever ``compute_dtype``
    says, as JAX's ``align_crop`` on its CPU backend."""
    imgs, Hs, _ = warp_case
    x, h = torch.from_numpy(imgs), torch.from_numpy(Hs)
    for mode in ("bfloat16", "int8"):
        cd = MODES[mode][1]
        assert torch.equal(homography.warp_perspective_batch_cuda(x, h, (O, O), cd),
                           homography.warp_perspective_batch(x, h, (O, O), cd))
    lms = torch.tensor([[[20.0, 24.0], [40.0, 23.0], [30.0, 38.0]]]).expand(B, 3, 2)
    base = torch.from_numpy(BASE)
    exact = homography.align_crop(x, lms, base, (O, O))
    for cd in (torch.bfloat16, torch.int8):
        assert torch.equal(homography.align_crop(x, lms, base, (O, O), compute_dtype=cd), exact)
    with pytest.raises(ValueError, match="compute_dtype"):
        homography.warp_perspective_batch_cuda(x, h, (O, O), torch.float16)
    with pytest.raises(ValueError, match="out_dtype"):
        homography.warp_perspective_batch(x, h, (O, O), out_dtype=torch.int8)


@pytest.fixture(scope="module")
def roi_case():
    rng = np.random.RandomState(3)
    feats = _pyramid(rng, 2)
    rois, bidx = _level_realistic_rois(rng, 2, 8)
    return feats, rois, bidx


@pytest.mark.parametrize("out", [7, 14])
def test_k3_bf16_matches_the_pallas_kernel(roi_case, out):
    feats, rois, bidx = roi_case
    strides = (4, 8, 16, 32)
    want = np.asarray(multilevel_roi_align_pallas(
        feats, jnp.asarray(rois), jnp.asarray(bidx), (out, out), strides, interpret=True,
        compute_dtype=jnp.bfloat16))
    levels = [torch.from_numpy(np.array(f)).to(torch.bfloat16) for f in feats]
    args = (torch.from_numpy(rois), torch.from_numpy(bidx), (out, out), strides)
    got = roi_align.multilevel_roi_align_bf16(levels, *args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    # the wrapper picks the instance from the levels' dtype on the CPU too
    assert torch.equal(roi_align.multilevel_roi_align_cuda(levels, *args), got)
    f32 = roi_align.multilevel_roi_align_cuda([lv.float() for lv in levels], *args)
    assert torch.equal(f32, roi_align.multilevel_roi_align([lv.float() for lv in levels], *args))
    # bfloat16 weights move the pooled values by at most a few bfloat16 steps
    assert np.abs(got.numpy() - f32.numpy()).max() <= 2.0 ** -6 * scale


@pytest.mark.parametrize("out", [7, 14])
def test_k4_bf16_matches_the_pallas_backward(roi_case, out):
    """K4 with bfloat16 operands against the Pallas backward
    (``compute_dtype=bfloat16``) in interpret mode: both round each sample's
    cotangent and weights to bfloat16 and sum in float32, in other orders, so
    the float32 sums (``_roi_backward``, before the custom VJP's cast) agree
    to 1e-5 of the scale, where the float32 operands' sums lie further off;
    the gradient through the custom VJP, rounded to the levels' bfloat16,
    agrees to one bfloat16 step where a sum sits at a rounding boundary (at
    most 2^-7 of the larger of the two)."""
    feats, rois, bidx = roi_case
    strides = (4, 8, 16, 32)
    g = np.random.RandomState(out).randn(len(rois), out, out, feats[0].shape[-1])
    g = g.astype(np.float32)

    def loss(levels):
        pooled = multilevel_roi_align_pallas_diff(
            list(levels), jnp.asarray(rois), jnp.asarray(bidx), (out, out), strides,
            interpret=True, compute_dtype=jnp.bfloat16)
        return jnp.sum(pooled * g)

    want = jax.grad(loss)(tuple(f.astype(jnp.bfloat16) for f in feats))
    shapes = [tuple(f.shape) for f in feats]
    args = (torch.from_numpy(rois), torch.from_numpy(bidx), (out, out), strides)
    got = roi_align.multilevel_roi_align_backward_bf16(torch.from_numpy(g), shapes, *args)
    sums = _roi_backward(jnp.asarray(g), jnp.asarray(rois), shapes, (out, out), strides, 2,
                         224.0, 4, 2, 5, True, jnp.bfloat16)
    sums = [np.asarray(w, np.float64) for w in sums]
    scale = max(float(np.abs(w).max()) for w in sums)
    f32 = roi_align.multilevel_roi_align_backward(torch.from_numpy(g), shapes, *args)

    def gap(levels):
        return max(float(np.abs(d.double().numpy() - w).max()) for d, w in zip(levels, sums))

    assert gap(got) <= 1e-5 * scale
    # float32 operands sit beyond that, a few bfloat16 steps off
    assert 1e-5 * scale < gap(f32) <= 2.0 ** -6 * scale
    for d, w in zip(got, want):
        assert d.dtype == torch.float32 and d.shape == w.shape and w.dtype == jnp.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        rounded = d.to(torch.bfloat16).float().numpy()
        step = 2.0 ** -7 * np.maximum(np.abs(w), np.abs(rounded))
        assert np.all(np.abs(rounded - w) <= step + 1e-5 * scale)
    # the wrapper on CPU tensors and the autograd function over bfloat16 levels
    # take this plain version and round its result to the levels' bfloat16
    wrapped = roi_align.multilevel_roi_align_backward_cuda(torch.from_numpy(g), shapes, *args,
                                                           dtype=torch.bfloat16)
    sums_out = roi_align.multilevel_roi_align_backward_cuda(
        torch.from_numpy(g), shapes, *args, dtype=torch.bfloat16, out_dtype=torch.float32)
    assert all(torch.equal(a, d) for a, d in zip(sums_out, got))
    levels = [torch.from_numpy(np.array(f)).to(torch.bfloat16).requires_grad_(True)
              for f in feats]
    pooled = roi_align.multilevel_roi_align_diff(levels, *args)
    (pooled * torch.from_numpy(g)).sum().backward()
    for d, wr, lv in zip(got, wrapped, levels):
        assert wr.dtype == lv.grad.dtype == torch.bfloat16
        assert torch.equal(wr, d.to(torch.bfloat16)) and torch.equal(lv.grad, wr)
