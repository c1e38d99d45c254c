"""The port's models at ``dtype=torch.bfloat16`` against their flax twins at
``dtype=jnp.bfloat16`` on the CPU, on weights carried over by ``weights.py``:
a bottleneck, a small ResNet trunk, the embedder, the FPN, the RPN head, the
box, keypoint and mask heads and the MobileNetV3 trunk. And the float32
default: every dtype-aware layer at ``dtype=torch.float32`` is the plain
``torch.nn`` layer to the bit, and so is a whole detector built of them.

Both frameworks round at the same points (flax's ``promote_dtype``: operands
cast to bfloat16, each product's float32 sum rounded to bfloat16, the bias
added in bfloat16; running-statistics BN in float32, rounded at its output),
so they differ only where two float32 sums taken in other orders round to
different bfloat16 neighbours. One layer therefore agrees to about one
bfloat16 step (2^-8 relative) on a few elements; a chain compounds those
steps. Values are compared by the relative L2 error, ``||got - want|| /
||want||``, against a tolerance stated with each test: 4e-3 for one layer
(half a step: most elements are equal), 2e-2 for a trunk or a head chain.
"""

from functools import partial

import flax.linen as fnn
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pets_face_recognition_tpu.models import embedder as j_embedder
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import mobilenet_v3 as j_mbv3
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.models import roi_heads as j_rh
from pets_face_recognition_tpu.models import rpn as j_rpn
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.models import (embedder, fpn, layers, rcnn, resnet,
                                                    roi_heads, rpn)
from pets_face_recognition_tpu_torch.models.mobilenet_v3 import MobileNetV3Large
from pets_face_recognition_tpu_torch.models.quant import QuantConv

from test_torch_port_models import load, randomize

torch.set_num_threads(1)

BF = jnp.bfloat16
T_BF = torch.bfloat16
STAGES = (1, 1, 1, 1)
LAYER_L2, CHAIN_L2 = 4e-3, 2e-2


def l2(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def test_bottleneck_matches_flax():
    """A strided bottleneck with its projection, frozen BN in bfloat16: one
    block, held at the one-layer tolerance doubled (three convolutions and a
    shortcut in series)."""
    rng = np.random.RandomState(0)
    norm = partial(fnn.BatchNorm, use_running_average=True, momentum=0.9, epsilon=1e-5, dtype=BF)
    jb = j_resnet.Bottleneck(16, stride=2, dtype=BF, norm=norm)
    x = rng.randn(2, 16, 16, 32).astype(np.float32)
    v = randomize(jax.eval_shape(jb.init, jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = jax.jit(jb.apply)(v, jnp.asarray(x))
    p, st = v["params"], v["batch_stats"]
    sd = {}
    for c in (1, 2, 3):
        sd[f"conv{c}.weight"] = weights._conv(p[f"conv{c}"]["kernel"])
        weights._bn(sd, f"bn{c}", p[f"bn{c}"], st[f"bn{c}"])
    sd["downsample.0.weight"] = weights._conv(p["downsample_conv"]["kernel"])
    weights._bn(sd, "downsample.1", p["downsample_bn"], st["downsample_bn"])
    port = load(resnet.Bottleneck(32, 16, 2, partial(resnet.FrozenBatchNorm2d, dtype=T_BF),
                                  dtype=T_BF), sd)
    with torch.no_grad():
        got = port(nchw(x))
    assert want.dtype == BF and got.dtype == T_BF
    assert l2(nhwc(got), want) < 2 * LAYER_L2


@pytest.mark.parametrize("fused_stem", [True, False])
def test_resnet_trunk_matches_flax(fused_stem):
    """The frozen-BN trunk, one block a stage, at 32 x 32: every level in
    bfloat16 within the chain tolerance (the JAX space-to-depth stem and its
    plain one against the port's plain 7 x 7 stem)."""
    rng = np.random.RandomState(0)
    model = j_resnet.ResNet(stage_sizes=STAGES, features_only=True, frozen_stats=True,
                            dtype=BF, fused_stem=fused_stem)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    v = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = jax.jit(model.apply)(v, jnp.asarray(x))
    port = load(resnet.ResNet(STAGES, features_only=True, dtype=T_BF),
                weights.resnet_state_dict(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = port(nchw(x))
    for k in ("c2", "c3", "c4", "c5"):
        assert want[k].dtype == BF and got[k].dtype == T_BF, k
        assert l2(nhwc(got[k]), want[k]) < CHAIN_L2, k


def test_small_basic_block_trunk_matches_flax():
    """``resnet18`` (basic blocks, frozen BN) in bfloat16, the classifier's
    ``fc`` in bfloat16 as JAX's ``nn.Dense(dtype=self.dtype)``."""
    rng = np.random.RandomState(8)
    model = j_resnet.resnet18(num_classes=10, frozen_stats=True, dtype=BF)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    v = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = jax.jit(model.apply)(v, jnp.asarray(x))
    port = load(resnet.resnet18(num_classes=10, frozen_stats=True, dtype=T_BF),
                weights.resnet_state_dict(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = port(nchw(x))
    assert want.dtype == BF and got.dtype == T_BF and got.shape == (2, 10)
    assert l2(got, want) < CHAIN_L2


def test_embedder_matches_flax_with_a_float32_fc():
    """The live-BN embedder in eval at bfloat16: the trunk in bfloat16, the
    ``fc`` in float32 on the pooled features cast to float32, as JAX's."""
    rng = np.random.RandomState(1)
    model = j_embedder.EmbeddingModel(backbone=j_resnet.ResNet(stage_sizes=STAGES, dtype=BF),
                                      dtype=BF)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    v = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    want = jax.jit(model.apply)(v, jnp.asarray(x))
    port = load(embedder.resnet50_embedder(512, stage_sizes=STAGES, dtype=T_BF),
                weights.embedder_state_dict(v))
    assert port.fc.compute_dtype == torch.float32
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert l2(got, want) < CHAIN_L2


def test_fpn_matches_flax():
    """The FPN at bfloat16: laterals, top-down adds, smoothing convs and the
    max-pool p6, each level within two layers' tolerance."""
    rng = np.random.RandomState(2)
    chans = (16, 32, 64, 128)
    feats = {f"c{i + 2}": rng.randn(2, 16 >> i, 16 >> i, c).astype(np.float32)
             for i, c in enumerate(chans)}
    jfeats = {k: jnp.asarray(v).astype(BF) for k, v in feats.items()}
    model = j_fpn.FPN(out_channels=32, dtype=BF)
    v = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(2), jfeats), rng)
    want = jax.jit(model.apply)(v, jfeats)
    port = load(fpn.FPN(chans, 32, dtype=T_BF), weights.fpn_state_dict(v["params"]))
    with torch.no_grad():
        got = port({k: nchw(x).to(T_BF) for k, x in feats.items()})
    for k in want:
        assert want[k].dtype == BF and got[k].dtype == T_BF, k
        assert l2(nhwc(got[k]), want[k]) < 2 * LAYER_L2, k


def test_rpn_head_matches_flax():
    """The RPN head's shared conv and both 1 x 1 predictors in bfloat16
    (``rpn.py:61-65``): bfloat16 logits and deltas."""
    rng = np.random.RandomState(3)
    C, A = 16, 3
    feats = {f"p{i + 2}": rng.randn(2, s, s, C).astype(np.float32)
             for i, s in enumerate((16, 8, 4, 2, 1))}
    model = j_rpn.RPNHead(num_anchors=A, dtype=BF)
    jfeats = {k: jnp.asarray(v).astype(BF) for k, v in feats.items()}
    v = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(3), jfeats), rng)
    want_l, want_d = jax.jit(model.apply)(v, jfeats)
    head = load(rpn.RPNHead(C, A, dtype=T_BF), weights.rpn_head_state_dict(v["params"]))
    with torch.no_grad():
        got_l, got_d = head([nchw(feats[k]).to(T_BF) for k in sorted(feats)])
    assert want_l.dtype == BF and got_l.dtype == T_BF and got_d.dtype == T_BF
    assert l2(got_l, want_l) < 2 * LAYER_L2
    assert l2(got_d, want_d) < 2 * LAYER_L2


def test_box_heads_match_flax():
    """``TwoMLPHead`` in bfloat16 (float32 pooled input cast by its first
    layer) and the float32 box predictor on its bfloat16 output."""
    rng = np.random.RandomState(4)
    K, C = 6, 8
    pooled = rng.randn(K, 7, 7, C).astype(np.float32)
    jh, jp = j_rh.TwoMLPHead(representation_size=64, dtype=BF), j_rh.FastRCNNPredictor(2)
    vh = randomize(jax.eval_shape(jh.init, jax.random.PRNGKey(4), jnp.asarray(pooled)), rng)
    feats = jax.jit(jh.apply)(vh, jnp.asarray(pooled))
    vp = randomize(jax.eval_shape(jp.init, jax.random.PRNGKey(5), feats), rng)
    want_s, want_d = jax.jit(jp.apply)(vp, feats)
    sd = weights.box_heads_state_dict(vh["params"], vp["params"])
    head = roi_heads.TwoMLPHead(7 * 7 * C, 64, dtype=T_BF)
    pred = roi_heads.FastRCNNPredictor(64, 2)
    load(head, {k[len("box_head."):]: v for k, v in sd.items() if k.startswith("box_head.")})
    load(pred, {k[len("box_predictor."):]: v for k, v in sd.items()
                if k.startswith("box_predictor.")})
    with torch.no_grad():
        h = head(torch.from_numpy(pooled))
        got_s, got_d = pred(h)
    assert feats.dtype == BF and h.dtype == T_BF
    assert want_s.dtype == jnp.float32 and got_s.dtype == torch.float32
    assert l2(h, feats) < 2 * LAYER_L2
    assert l2(got_s, want_s) < 2 * LAYER_L2
    assert l2(got_d, want_d) < 2 * LAYER_L2


def test_keypoint_heads_match_flax():
    """The keypoint head's eight convolutions in bfloat16, the transposed-conv
    predictor and the 2x upsample in float32: float32 heatmaps."""
    rng = np.random.RandomState(5)
    K, C, NK = 2, 16, 3
    pooled = rng.randn(K, 14, 14, C).astype(np.float32)
    model = j_rh.KeypointHead(num_keypoints=NK, channels=32, dtype=BF)
    v = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(6), jnp.asarray(pooled)), rng)
    want = jax.jit(model.apply)(v, jnp.asarray(pooled))
    sd = weights.keypoint_heads_state_dict(v["params"])
    head = roi_heads.KeypointHead(C, channels=32, dtype=T_BF)
    pred = roi_heads.KeypointPredictor(32, NK)
    load(head, {k[len("keypoint_head."):]: v for k, v in sd.items()
                if k.startswith("keypoint_head.")})
    load(pred, {k[len("keypoint_predictor."):]: v for k, v in sd.items()
                if k.startswith("keypoint_predictor.")})
    with torch.no_grad():
        h = head(nchw(pooled))
        got = pred(h)
    assert h.dtype == T_BF and want.dtype == jnp.float32 and got.dtype == torch.float32
    assert got.shape == want.shape == (K, 56, 56, NK)
    assert l2(got, want) < CHAIN_L2


def test_mask_heads_match_flax():
    """The mask head's four convolutions and ``conv5_mask`` in bfloat16, the
    per-class logits in float32."""
    rng = np.random.RandomState(7)
    K, C = 3, 16
    pooled = rng.randn(K, 14, 14, C).astype(np.float32)
    model = j_rh.MaskHead(num_classes=2, channels=32, dtype=BF)
    v = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(7), jnp.asarray(pooled)), rng)
    want = jax.jit(model.apply)(v, jnp.asarray(pooled))
    sd = weights.mask_heads_state_dict(v["params"])
    head = roi_heads.MaskHead(C, channels=32, dtype=T_BF)
    pred = roi_heads.MaskPredictor(32, 2, channels=32, dtype=T_BF)
    load(head, {k[len("mask_head."):]: v for k, v in sd.items() if k.startswith("mask_head.")})
    load(pred, {k[len("mask_predictor."):]: v for k, v in sd.items()
                if k.startswith("mask_predictor.")})
    with torch.no_grad():
        got = pred(head(nchw(pooled)))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert got.shape == want.shape == (K, 28, 28, 2)
    assert l2(got, want) < CHAIN_L2


@pytest.mark.parametrize("size", [64, 65], ids=["even_fused_stem", "odd_plain_stem"])
def test_mobilenet_trunk_matches_flax(size):
    """The MobileNetV3 trunk's inverted residual blocks (expand, depthwise,
    squeeze-excite with its mean and hard sigmoid, project, residual) at
    bfloat16, frozen BN rounding to bfloat16: the four taps within the chain
    tolerance."""
    rng = np.random.RandomState(size)
    model = j_mbv3.MobileNetV3Large(features_only=True, frozen_stats=True, dtype=BF)
    x = rng.rand(2, size, size, 3).astype(np.float32)
    v = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = jax.jit(model.apply)(v, jnp.asarray(x))
    port = MobileNetV3Large(features_only=True, frozen_stats=True, dtype=T_BF)
    port.load_state_dict(weights.to_tensors(weights.mobilenet_state_dict(
        v["params"], v["batch_stats"])), strict=True)
    with torch.no_grad():
        got = port.eval()(nchw(x))
    for k in ("c2", "c3", "c4", "c5"):
        assert want[k].dtype == BF and got[k].dtype == T_BF, k
        assert l2(nhwc(got[k]), want[k]) < CHAIN_L2, k


def test_live_batchnorm_rounds_only_in_eval():
    """``LiveBatchNorm2d(dtype=bfloat16)``: in eval the float32 norm's output
    rounded to bfloat16; in training float32 (flax computes batch statistics
    in float32)."""
    bn, ref = resnet.LiveBatchNorm2d(4, dtype=T_BF), resnet.LiveBatchNorm2d(4)
    ref.load_state_dict(bn.state_dict())
    x = torch.randn(2, 4, 3, 3).to(T_BF)
    y = bn.eval()(x)
    assert y.dtype == T_BF and torch.equal(y, ref.eval()(x.float()).to(T_BF))
    assert bn.train()(x).dtype == torch.float32


def test_unknown_dtype_and_bf16_quant_twins_are_refused():
    """A dtype other than float32 and bfloat16 is refused by every layer, the
    int8 twins' included. The int8 twins themselves now compute in bfloat16
    too (their ``QuantConv`` in the model's dtype, as JAX's pass
    ``dtype=self.dtype``); at the float32 default they stay float32, as JAX's
    serving configs build them."""
    with pytest.raises(ValueError, match="model dtype"):
        layers.Conv2d(3, 4, 1, dtype=torch.float16)
    with pytest.raises(ValueError, match="model dtype"):
        resnet.ResNet(STAGES, features_only=True, quant="int8", dtype=torch.float16)
    twin = resnet.ResNet(STAGES, features_only=True, quant="int8", dtype=T_BF)
    assert {m.compute_dtype for m in twin.modules() if isinstance(m, QuantConv)} == {T_BF}
    det = rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES, quant="calibrate",
                                         quant_kp="calibrate")
    assert det.dtype == torch.float32
    assert {m.compute_dtype for m in det.modules() if isinstance(m, QuantConv)} == {torch.float32}


def _plain_twin(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` with every dtype-aware layer turned back into its ``torch.nn``
    class, sharing the weights."""
    import copy

    twin = copy.deepcopy(model)
    for m in twin.modules():
        for cls, base in ((layers.Conv2d, torch.nn.Conv2d),
                          (layers.ConvTranspose2d, torch.nn.ConvTranspose2d),
                          (layers.Linear, torch.nn.Linear)):
            if type(m) is cls:
                m.__class__ = base
    return twin


def test_float32_default_is_the_plain_torch_layers_to_the_bit():
    """At the float32 default each dtype-aware layer is its ``torch.nn`` layer,
    and a keypoint R-CNN built of them gives the same float32 bits as the
    same R-CNN with ``torch.nn`` layers (the port before models took a dtype),
    detections and heatmaps alike."""
    g = torch.Generator().manual_seed(0)
    for layer, x in ((layers.Conv2d(8, 6, 3, padding=1), torch.randn(2, 8, 5, 5, generator=g)),
                     (layers.ConvTranspose2d(8, 3, 4, 2, 1), torch.randn(2, 8, 5, 5, generator=g)),
                     (layers.Linear(8, 6), torch.randn(4, 8, generator=g))):
        assert layer.compute_dtype == torch.float32
        assert torch.equal(layer(x), _plain_twin(layer)(x))
    det = rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES, rpn_pre_nms_top_n_test=32,
                                         rpn_post_nms_top_n_test=8)
    weights.init_random_(det, 3)
    det.eval()
    images = torch.rand(2, 64, 64, 3, generator=g)
    with torch.no_grad():
        got, want = det(images), _plain_twin(det)(images)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
