"""Swin-T and ConvNeXt-T computing in bfloat16 against the JAX package's on
the CPU: the narrow trunks at ``dtype=bfloat16`` against flax's at
``dtype=jnp.bfloat16``, and the keypoint R-CNN factories built with
``dtype=torch.bfloat16`` against JAX's factories cloned to ``jnp.bfloat16``
at trunk, FPN and model, as its training bench clones them
(``tools/bench_train.py:110-112``), with the trunk narrowed as
``test_torch_port_alt_rcnn.py`` narrows it: the FPN pyramid and the RPN's
logits and deltas, then a bfloat16 eval and a bfloat16 training step of each
port detector, finite and through K3's and K4's bfloat16 instances.

Rounding points (JAX ``swin.py:66-253``, ``convnext.py:25-60``): Dense and
Conv layers in bfloat16, every LayerNorm in float32; Swin's attention scores
summed in float32 from bfloat16 operands, its softmax rounded to the values'
bfloat16 before the product with V (``attn.astype(v.dtype)``); ConvNeXt's
float32 layer scale brings its residual stream to float32. Both frameworks
round at those points, so they differ where float32 sums in other orders
round to different bfloat16 neighbours: a chain of layers agrees to the
chain tolerance of ``test_torch_port_bf16_models.py``, 2e-2 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.models import convnext as j_convnext
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import swin as j_swin
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
from pets_face_recognition_tpu_torch.models import convnext, layers, rcnn, swin
from pets_face_recognition_tpu_torch.ops import roi_align
from pets_face_recognition_tpu_torch.utils.optim import detection_sgd_optimizer

from test_torch_port_alt_rcnn import CONVNEXT, SWIN, TRAIN
from test_torch_port_bf16_train import bench_clone
from test_torch_port_swin import randomize_alt

torch.set_num_threads(1)

BF, T_BF = jnp.bfloat16, torch.bfloat16
CHAIN_L2 = 2e-2
IMG = 128


def l2(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    got = got.float().numpy().astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def trunks(name):
    if name == "swin":
        kw = dict(features_only=True, window_size=4, **SWIN)
        return j_swin.SwinTransformer(dtype=BF, **kw), swin.SwinTransformer(dtype=T_BF, **kw), \
            weights.swin_state_dict
    kw = dict(features_only=True, **CONVNEXT)
    return j_convnext.ConvNeXt(dtype=BF, **kw), convnext.ConvNeXt(dtype=T_BF, **kw), \
        weights.convnext_state_dict


@pytest.mark.parametrize("name", ["swin", "convnext"])
def test_bf16_trunk_matches_flax(name):
    """``c2..c5`` of the narrow trunk within the chain tolerance, each in
    flax's dtype: bfloat16 for Swin (its stream is the Dense layers'),
    float32 for ConvNeXt (the layer scale's)."""
    rng = np.random.RandomState(11)
    x = rng.rand(2, IMG, IMG, 3).astype(np.float32)
    j_model, port, bridge = trunks(name)
    variables = randomize_alt(jax.eval_shape(j_model.init, jax.random.PRNGKey(0),
                                             jnp.asarray(x)), rng)
    want = jax.jit(j_model.apply)(variables, jnp.asarray(x))
    port.load_state_dict(weights.to_tensors(bridge(variables["params"])), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in ("c2", "c3", "c4", "c5"):
        assert got[k].dtype == (T_BF if want[k].dtype == BF else torch.float32), k
        assert l2(got[k].permute(0, 2, 3, 1), want[k]) <= CHAIN_L2, k
    assert {p.dtype for p in port.parameters()} == {torch.float32}


def detector_twins(name):
    """JAX's keypoint R-CNN factory with its trunk narrowed, cloned to
    bfloat16 at trunk, FPN and model; the port's factory at
    ``dtype=bfloat16`` with the same narrowed trunk under its FPN."""
    j_det = getattr(j_rcnn, name)(**TRAIN)
    port = getattr(rcnn, name)(dtype=T_BF, **TRAIN)
    levels = port.backbone.fpn.in_levels
    if name.startswith("swin"):
        body = j_swin.SwinTransformer(features_only=True, window_size=4, **SWIN)
        trunk = swin.SwinTransformer(features_only=True, window_size=4, dtype=T_BF, **SWIN)
    else:
        body = j_convnext.ConvNeXt(features_only=True, **CONVNEXT)
        trunk = convnext.ConvNeXt(features_only=True, dtype=T_BF, **CONVNEXT)
    assert port.dtype == port.backbone.fpn.inner_blocks[0].compute_dtype == T_BF
    port.backbone = rcnn._fpn_over(trunk, levels, T_BF)
    j_det = bench_clone(j_det.clone(backbone=j_det.backbone.clone(backbone=body)))
    return j_det, port


def _rpn(m, x):
    """The FPN pyramid and the RPN head's logits and deltas (a flax method)."""
    feats = m.backbone(x, train=False)
    return feats, m.rpn_head(feats)


@pytest.mark.parametrize("name", ["swin_tiny_keypoint_rcnn", "convnext_tiny_keypoint_rcnn"])
def test_bf16_factory_matches_jax_clone(name):
    """The bfloat16 detector's pyramid (``p2..p6``) and its RPN's logits and
    deltas within the chain tolerance of JAX's clone; then an eval and a
    training step of the port's on the CPU: finite, the RoIs pooled by K3's
    bfloat16 instance and, in the step, differentiated by K4's, the
    parameters and gradients float32."""
    j_det, port = detector_twins(name)
    rng = np.random.RandomState(12)
    x = rng.rand(2, IMG, IMG, 3).astype(np.float32)
    variables = randomize_alt(jax.eval_shape(j_det.init, jax.random.PRNGKey(0),
                                             jnp.asarray(x)), rng)
    feats, (logits, deltas) = jax.jit(lambda v, x: j_det.apply(v, x, method=_rpn))(
        variables, jnp.asarray(x))
    port.load_state_dict(weights.to_tensors(weights.detection_state_dict(variables)))
    port.eval()
    with torch.no_grad():
        got = port.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
        names = sorted(got, key=lambda n: int(n[1:]))
        got_logits, got_deltas = port.rpn([got[n] for n in names])
    assert sorted(got) == sorted(feats)
    for k in got:
        assert got[k].dtype == T_BF and feats[k].dtype == BF, k
        assert l2(got[k].permute(0, 2, 3, 1), feats[k]) <= CHAIN_L2, k
    assert got_logits.dtype == T_BF and logits.dtype == BF
    assert l2(got_logits, logits) <= CHAIN_L2 and l2(got_deltas, deltas) <= CHAIN_L2

    calls = []
    real = {n: getattr(roi_align, n) for n in ("multilevel_roi_align_bf16",
                                               "multilevel_roi_align_backward_bf16")}
    with pytest.MonkeyPatch.context() as mp:
        for n, fn in real.items():
            mp.setattr(roi_align, n, lambda *a, _f=fn, _n=n, **k: calls.append(_n) or _f(*a, **k))
        with torch.no_grad():
            dets = port(torch.from_numpy(x))
        assert calls.count("multilevel_roi_align_bf16") == 2
        assert all(torch.isfinite(v).all() for v in dets.values() if v.is_floating_point())
        ctl = KeyPointsController(optimizer_fn=lambda p: detection_sgd_optimizer(p, 5e-3))
        state = ctl.init_state(0, "cpu", model=port)
        out = ctl.train_step(state, synthetic_keypoint_batch(2, IMG, IMG, 2, seed=5))
    assert np.isfinite(out["loss"])
    assert calls.count("multilevel_roi_align_bf16") == 4
    assert calls.count("multilevel_roi_align_backward_bf16") == 2
    for p in port.parameters():
        assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
    assert isinstance(port.backbone.body.stage1.patch_partition.linear if name.startswith("swin")
                      else port.backbone.body.stem_conv, (layers.Linear, layers.Conv2d))
