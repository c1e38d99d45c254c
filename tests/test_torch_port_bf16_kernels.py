"""The plain versions of the port's reduced-precision kernel instances against
the JAX package's Pallas kernels in interpret mode, on the CPU: K1's bfloat16
and int8 compute modes and its bfloat16 output
(``warp_affine_batch_pallas(..., compute_dtype=, out_dtype=)``), and K3 on
bfloat16 levels (``multilevel_roi_align_pallas(..., compute_dtype=bfloat16)``).
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
import jax.numpy as jnp

from pets_face_recognition_tpu.ops.homography import solve_homography
from pets_face_recognition_tpu.ops.pallas_roi_align import multilevel_roi_align_pallas
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


def test_k3_bf16_levels_have_no_backward(roi_case):
    """K4 takes float32 levels only: the backward over bfloat16 levels raises
    instead of running another route."""
    feats, rois, bidx = roi_case
    levels = [torch.from_numpy(np.array(f)).to(torch.bfloat16).requires_grad_(True)
              for f in feats]
    out = roi_align.multilevel_roi_align_diff(levels, torch.from_numpy(rois),
                                              torch.from_numpy(bidx), (7, 7), (4, 8, 16, 32))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        out.sum().backward()
