"""The bfloat16 RoIAlign pair as the kernels compute it since their Hopper
redesign, on the CPU.

K4-bf16 contracts over samples, not bins: for each RoI,
``out[y, x, c] = sum_sx Wx[sx, x] sum_sy Wy[sy, y] G[sy, sx, c]`` with ``Wy``,
``Wx`` each sample's rounded weights and ``G`` the rounded ``g / s^2`` of its
bin, the inner sum on the tensor cores (float32 sums of exact products, 16
sample rows a step), the outer one in float32 with each bin column's rounded
weights summed. A numpy model of that arithmetic lies within 1e-5 of the
value scale of the plain version (``multilevel_roi_align_backward_bf16``),
where the float32 operands' gradient lies beyond; every ``Wy`` entry is one
bfloat16 number, so the tensor cores take it as it is. The K4 wrapper reads
a bfloat16 cotangent as it comes (the same bits as its float32 copy), and
K3's ``out_dtype`` is its float32 result rounded.

The models pool into bfloat16 where the head that reads the pooled values
computes in bfloat16 (the box head's ``fc6``, the mask and keypoint heads'
first convolutions): a bfloat16 keypoint R-CNN training step and the
detectors' eval forwards are bit-equal to the same runs with every RoIAlign
output float32 (today's) and with the bfloat16 outputs cast back to float32;
an int8 keypoint head (its ``ActQuant`` reads float32 values) keeps float32.

Sizes: p2..p5 of 160 x 160 images (40² .. 5²), C = 16, RoIs across the
levels, off the edges, narrow and tiny; the step is the trunk stages
(1, 1, 1, 1) keypoint R-CNN of ``test_torch_port_bf16_train.py`` at B = 2 x
128².
"""

import numpy as np
import pytest
import torch

from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
from pets_face_recognition_tpu_torch.models import rcnn
from pets_face_recognition_tpu_torch.ops import roi_align
from pets_face_recognition_tpu_torch.utils.optim import detection_sgd_optimizer

torch.set_num_threads(1)

STRIDES = (4, 8, 16, 32)
IMAGE, B, C = 160, 2, 16
SHAPES = [(B, IMAGE // s, IMAGE // s, C) for s in STRIDES]
MMA_DEPTH = 16                          # sample rows an m16n8k16 step takes
STAGES = (1, 1, 1, 1)
STEP_B, STEP_IMG, STEP_G = 2, 128, 2
BUDGETS = dict(rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=32,
               box_batch_size_per_image=16, rpn_pre_nms_top_n_test=32,
               rpn_post_nms_top_n_test=8)


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to bfloat16 (to nearest even) and back."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _rois(rng, per_image: int):
    """RoIs over every level (sides 16-300 px), a fifth of them off an image
    edge, some 5:1, one tiny and one wholly outside the image."""
    rois, bidx = [], []
    for b in range(B):
        for i in range(per_image):
            side = 16 * 2 ** rng.uniform(0, 4.2)
            ar = 5.0 if i % 5 == 1 else rng.uniform(0.6, 1.6)
            w, h = side * np.sqrt(ar), side / np.sqrt(ar)
            cx, cy = rng.uniform(-0.1, 1.1, 2) * IMAGE
            rois.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
            bidx.append(b)
    rois += [[3.2, 150.1, 5.0, 151.3], [400.0, 420.0, 460.0, 470.0]]
    bidx += [0, 1]
    return np.asarray(rois, np.float32), np.asarray(bidx, np.int32)


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(19)
    rois, bidx = _rois(rng, 12)
    return rois, bidx, rng


def _axis_weights(start, bin_size, n, s, limit):
    """Each sample's rounded tap weights on the cells of one axis:
    ``(n * s, limit)``, the tap rules of ``ops/roi_align.py::_taps`` (a
    sample out of bounds weighs nothing; the last cell's high tap weighs 0)."""
    w = np.zeros((n * s, limit), np.float32)
    for i in range(n):
        for p in range(s):
            off = np.float32(i) + (np.float32(p) + np.float32(0.5)) / np.float32(s)
            pos = np.float32(start + off * bin_size)
            if pos <= -1 or pos >= limit:
                continue
            c = max(pos, np.float32(0))
            low = min(int(np.floor(c)), limit - 1)
            edge = low >= limit - 1
            high = low if edge else low + 1
            lw = np.float32(0) if edge else np.float32(c - np.float32(low))
            hw = np.float32(1) - lw
            w[i * s + p, low] += bf16([hw])[0]
            w[i * s + p, high] += bf16([lw])[0]
    return w


def mma_model_backward(g, rois, bidx, out, s=2):
    """K4-bf16's arithmetic in numpy float32: per RoI, ``T = Wy^T G`` summed
    in float32 blocks of ``MMA_DEPTH`` sample rows (one tensor-core step
    each) from the even sample row at or before the first bin with a sample
    in bounds, then ``out = T Ax`` with ``Ax`` the bin columns' rounded
    weights summed; returns the float32 level gradients and every RoI's
    ``Wy``."""
    lvl = roi_align.roi_levels(torch.from_numpy(rois), 2, 5).numpy()
    grads = [np.zeros(sh, np.float32) for sh in SHAPES]
    G = bf16(g / np.float32(s * s))
    wys = []
    for k in range(len(rois)):
        b = int(bidx[k])
        level = int(lvl[k])
        _, H, W, _ = SHAPES[level]
        x1, y1, x2, y2 = rois[k] * np.float32(1.0 / STRIDES[level])
        bin_h = np.float32(max(y2 - y1, np.float32(1)) / np.float32(out))
        bin_w = np.float32(max(x2 - x1, np.float32(1)) / np.float32(out))
        wy = _axis_weights(y1, bin_h, out, s, H)              # (out * s, H)
        wx = _axis_weights(x1, bin_w, out, s, W)              # (out * s, W)
        wys.append(wy)
        gs = np.repeat(G[k], s, axis=0)                        # (out * s, out, C)
        t = np.zeros((H, out, C), np.float32)
        live = np.flatnonzero(wy.any(axis=1))
        sy0 = (live[0] // s * s) & ~1 if len(live) else out * s
        for d in range(sy0, out * s, MMA_DEPTH):
            t += np.einsum("sy,spc->ypc", wy[d:d + MMA_DEPTH], gs[d:d + MMA_DEPTH])
        ax = wx.reshape(out, s, W).sum(axis=1, dtype=np.float32)   # (out, W): bins x cells
        grads[level][b] += np.einsum("xp,ypc->yxc", ax.T, t).astype(np.float32)
    return grads, wys


@pytest.mark.parametrize("out", [7, 14])
def test_k4_bf16_mma_model_matches_the_plain_version(case, out):
    rois, bidx, rng = case
    g = rng.randn(len(rois), out, out, C).astype(np.float32)
    model, wys = mma_model_backward(g, rois, bidx, out)
    args = (torch.from_numpy(g), SHAPES, torch.from_numpy(rois), torch.from_numpy(bidx),
            (out, out), STRIDES)
    plain = roi_align.multilevel_roi_align_backward_bf16(*args)
    f32 = roi_align.multilevel_roi_align_backward(*args)
    scale = max(float(np.abs(p.numpy()).max()) for p in plain)

    def gap(levels):
        return max(float(np.abs(m - d.numpy()).max()) for m, d in zip(model, levels))

    assert gap(plain) <= 1e-5 * scale
    # float32 operands sit beyond that band
    assert gap(f32) > 1e-5 * scale
    # every operand of the tensor-core contraction is one bfloat16 number
    assert all(np.array_equal(bf16(wy), wy) for wy in wys)
    assert any((wy != 0).any() for wy in wys)


@pytest.mark.parametrize("out,s", [(7, 1), (7, 3), (14, 3)])
def test_k4_bf16_mma_model_with_other_sampling_ratios(case, out, s):
    """The kernel's instance for sampling ratios other than 2: with S odd a
    block's first sample row may fall inside a bin that misses it, and then
    the depth steps start one row earlier, on a row of zero weights."""
    rois, bidx, rng = case
    g = rng.randn(len(rois), out, out, C).astype(np.float32)
    model, wys = mma_model_backward(g, rois, bidx, out, s)
    plain = roi_align.multilevel_roi_align_backward_bf16(
        torch.from_numpy(g), SHAPES, torch.from_numpy(rois), torch.from_numpy(bidx),
        (out, out), STRIDES, sampling_ratio=s)
    scale = max(float(np.abs(p.numpy()).max()) for p in plain)
    assert max(float(np.abs(m - d.numpy()).max()) for m, d in zip(model, plain)) <= 1e-5 * scale
    assert all(np.array_equal(bf16(wy), wy) for wy in wys)


@pytest.mark.parametrize("out", [7, 14])
def test_k4_wrapper_reads_a_bf16_cotangent_as_its_float32_copy(case, out):
    rois, bidx, rng = case
    g = torch.from_numpy(rng.randn(len(rois), out, out, C).astype(np.float32))
    g = g.to(torch.bfloat16)
    args = (SHAPES, torch.from_numpy(rois), torch.from_numpy(bidx), (out, out), STRIDES)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = roi_align.multilevel_roi_align_backward_cuda(g, *args, dtype=torch.bfloat16,
                                                           out_dtype=out_dtype)
        want = roi_align.multilevel_roi_align_backward_cuda(g.float(), *args,
                                                            dtype=torch.bfloat16,
                                                            out_dtype=out_dtype)
        assert all(a.dtype == out_dtype and torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("out", [7, 14])
def test_k3_bf16_out_dtype_is_the_float32_result_rounded(case, out):
    rois, bidx, rng = case
    levels = [torch.from_numpy(rng.randn(*sh).astype(np.float32)).to(torch.bfloat16)
              for sh in SHAPES]
    args = (levels, torch.from_numpy(rois), torch.from_numpy(bidx), (out, out), STRIDES)
    f32 = roi_align.multilevel_roi_align_bf16(*args)
    rounded = roi_align.multilevel_roi_align_bf16(*args, out_dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and rounded.dtype == torch.bfloat16
    assert torch.equal(rounded, f32.to(torch.bfloat16))
    # the wrapper on CPU tensors
    assert torch.equal(roi_align.multilevel_roi_align_cuda(*args, out_dtype=torch.bfloat16),
                       rounded)
    with pytest.raises(ValueError, match="output"):
        roi_align.multilevel_roi_align_cuda(*args, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="output"):
        roi_align.multilevel_roi_align_cuda([f.float() for f in levels], *args[1:],
                                            out_dtype=torch.bfloat16)


def test_prepass_maps_levels_itself(case):
    """The pre-pass wrapper takes no levels: its keys are ``roi_levels``'
    level times B plus the image, for the level range it is given."""
    rois, bidx, _ = case
    r, b = torch.from_numpy(rois), torch.from_numpy(bidx)
    key, fp = roi_align.roi_footprints_cuda(SHAPES[2:], r, b, (7, 7), STRIDES[2:],
                                            min_level=4, max_level=5)
    lvl = roi_align.roi_levels(r, 4, 5)
    assert torch.equal(key, lvl * B + b)
    assert torch.equal(fp, roi_align.roi_footprints(SHAPES[2:], r, lvl, (7, 7), STRIDES[2:]))


class PooledDtypes:
    """Wraps ``rcnn.multilevel_roi_align_diff``: records each call's output
    size and dtype; ``mode`` "new" leaves the call as it is, "float32" asks
    every site for float32 (the pooled values before the sites pooled into
    bfloat16), "cast" casts a bfloat16 result back to float32."""

    def __init__(self, mp, mode: str = "new"):
        self.seen = []
        real = rcnn.multilevel_roi_align_diff

        def call(*args, out_dtype=torch.float32, **kw):
            if mode == "float32":
                out_dtype = torch.float32
            out = real(*args, out_dtype=out_dtype, **kw)
            self.seen.append((tuple(args[3]), out.dtype))
            return out.float() if mode == "cast" else out

        mp.setattr(rcnn, "multilevel_roi_align_diff", call)


@pytest.fixture(scope="module")
def step_batch():
    batch = synthetic_keypoint_batch(STEP_B, STEP_IMG, STEP_IMG, STEP_G, seed=3)
    rng = np.random.RandomState(5)
    anchors = 3 * sum((STEP_IMG // s) ** 2 for s in (4, 8, 16, 32, 64))
    noise = {"rpn": rng.uniform(size=(STEP_B, anchors)).astype(np.float32),
             "box": rng.uniform(size=(STEP_B, BUDGETS["rpn_post_nms_top_n_train"] + STEP_G))
             .astype(np.float32)}
    model = rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES, dtype=torch.bfloat16,
                                           **BUDGETS)
    sd = {k: v.clone() for k, v in weights.init_random_(model, 7).state_dict().items()}
    return batch, noise, sd


def _keypoint_step(step_batch, mode):
    batch, noise, sd = step_batch
    model = rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES, dtype=torch.bfloat16, **BUDGETS)
    model.load_state_dict(sd)
    ctl = KeyPointsController(optimizer_fn=lambda p: detection_sgd_optimizer(p, 5e-3))
    state = ctl.init_state(0, "cpu", model=model)
    with pytest.MonkeyPatch.context() as mp:
        spy = PooledDtypes(mp, mode)
        out = ctl.train_step(state, batch, sampler_noise={k: torch.from_numpy(v)
                                                          for k, v in noise.items()})
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return out, grads, spy.seen


@pytest.fixture(scope="module")
def new_step(step_batch):
    return _keypoint_step(step_batch, "new")


def test_bf16_step_pools_into_bf16_at_the_head_sites(new_step):
    _, grads, seen = new_step
    assert seen == [((7, 7), torch.bfloat16), ((14, 14), torch.bfloat16)]
    assert all(g.dtype == torch.float32 for g in grads.values())


@pytest.mark.parametrize("mode", ["float32", "cast"])
def test_bf16_step_is_bit_equal_with_float32_pooled_values(step_batch, new_step, mode):
    out, grads, _ = new_step
    ref_out, ref_grads, seen = _keypoint_step(step_batch, mode)
    assert [dt for _, dt in seen] == [torch.float32 if mode == "float32" else torch.bfloat16] * 2
    loss_terms = [k for k in out if k.startswith("loss")]
    assert loss_terms and all(float(out[k]) == float(ref_out[k]) for k in loss_terms)
    assert sorted(grads) == sorted(ref_grads)
    assert all(torch.equal(g, ref_grads[n]) for n, g in grads.items()), \
        [n for n, g in grads.items() if not torch.equal(g, ref_grads[n])]
    assert any(bool(g.abs().max() > 0) for n, g in grads.items() if "roi_heads" in n)


def _eval(factory, sd, images, mode, **kw):
    model = factory(stage_sizes=STAGES, dtype=torch.bfloat16, **BUDGETS, **kw)
    model.load_state_dict(sd)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        spy = PooledDtypes(mp, mode)
        out = model.eval()(images)
    return out, spy.seen


@pytest.mark.parametrize("factory,site", [(rcnn.keypointrcnn_resnet50_fpn, "keypoint"),
                                          (rcnn.maskrcnn_resnet50_fpn, "mask")])
def test_bf16_eval_is_bit_equal_with_float32_pooled_values(factory, site):
    model = factory(stage_sizes=STAGES, dtype=torch.bfloat16, **BUDGETS)
    sd = {k: v.clone() for k, v in weights.init_random_(model, 3).state_dict().items()}
    images = torch.from_numpy(np.random.RandomState(2).uniform(
        0, 1, (STEP_B, STEP_IMG, STEP_IMG, 3)).astype(np.float32))
    new, seen = _eval(factory, sd, images, "new")
    assert [dt for _, dt in seen] == [torch.bfloat16] * 2
    for mode in ("float32", "cast"):
        ref, _ = _eval(factory, sd, images, mode)
        assert sorted(new) == sorted(ref)
        assert all(torch.equal(v, ref[k]) for k, v in new.items()), (site, mode)


def test_int8_keypoint_head_keeps_float32_pooled_values():
    """An int8 twin's keypoint head observes and quantizes float32 pooled
    values (its first ``ActQuant``): that site stays float32, the box head's
    pools into bfloat16."""
    model = rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES, dtype=torch.bfloat16,
                                           quant_kp="calibrate", **BUDGETS)
    weights.init_random_(model, 4)
    assert model.roi_heads.keypoint_head.input_dtype == torch.float32
    images = torch.from_numpy(np.random.RandomState(6).uniform(
        0, 1, (1, STEP_IMG, STEP_IMG, 3)).astype(np.float32))
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        spy = PooledDtypes(mp)
        model.eval()(images)
    assert spy.seen == [((7, 7), torch.bfloat16), ((14, 14), torch.float32)]
    # a float32 detector pools float32 throughout
    f32 = rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES, **BUDGETS)
    weights.init_random_(f32, 4)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        spy = PooledDtypes(mp)
        f32.eval()(images)
    assert spy.seen == [((7, 7), torch.float32), ((14, 14), torch.float32)]
