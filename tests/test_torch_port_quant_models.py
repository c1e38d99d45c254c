"""The port's int8 serving models against the JAX package on the CPU: the
ResNet trunk, the embedder, the keypoint R-CNN at ``quant_scope`` ``trunk``
and ``fpn``, and ``quant_kp`` on the MobileNetV3 detector, whose trunk has
no int8 path (``test_torch_port_quant_detectors.py`` holds the other scopes,
``quant_kp`` on the ResNet-50 detector and Mask R-CNN).

Each case builds the JAX calibrate and int8 twins over random variables,
calibrates both frameworks on the same two batches and compares:

- the port's calibrate forward with its float forward, bit for bit;
- the calibrated state: every scale within 1e-5 relative of JAX's (the float
  activations differ at rounding level between the frameworks), ``weight_q``
  bit-equal and ``w_scale`` exact;
- the int8 outputs, on JAX's quant state carried over
  (``weights.quant_state_dict``), within JAX's own spread when its input is
  rounded differently (1e-7, 1e-6 and 1e-5 relative) plus 1e-5 relative for
  the trunk and the embedder, plus 1e-4 (the float models' tolerance) for
  the detectors, whose float parts chain further; a
  quantized activation that sits within rounding of a step flips by one
  between the frameworks, so the flips are counted at every ``ActQuant``
  and must be rare and of one step.

The JAX state starts as its ``PTQServing``'s ``init`` on zeros leaves it
(every scale at the 1e-6 floor, ``seen`` set: flax's fresh initialisation
maps zeros to zeros), which ``test_jax_init_seeds_the_floor`` checks and the
port's ``seed_calibration`` copies. Trunks are one block a stage at 64 x 64;
the JAX detector's dense RoIAlign limit is set to 0, so that both frameworks
pool by the float32 gather.

XLA's CPU backend has no fast integer convolution: JAX's int8 convolutions
take ~20x a float32 one there. While JAX runs, ``exact_int8_convolutions``
computes each of them as two float32 convolutions of the input's 4-bit
halves, whose every partial sum is an integer below 2^24, so the int32
result is the same bit for bit (``test_exact_int8_convolution_is_xla_s``
holds it at the widest reduction the models have).
"""

import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pets_face_recognition_tpu.models import embedder as j_embedder
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import ptq as j_ptq
from pets_face_recognition_tpu.models import quant as jq
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.device import float32_matmuls
from pets_face_recognition_tpu_torch.models import embedder, ptq, quant, rcnn, resnet

from test_torch_port_models import randomize

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
B, IMG, PRE, POST = 2, 64, 32, 8
# JAX's own spread: its int8 output when the input is rounded differently,
# one draw each at 1e-7, 1e-6 and 1e-5 relative (two draws more at 1e-5).
# At 1e-7 JAX's int8 output seldom moves at all (no activation flips),
# while the frameworks' float epilogues (norms, dequantization, adds)
# differ at rounding level in every layer, not only at the input
ROUNDINGS = (1e-7, 1e-6, 1e-5, 1e-5, 1e-5)
# the float parts of an int8 model (the stem, the FPN and the box head
# outside their scopes, the keypoint deconvolution) differ between the
# frameworks as the float models do, which the float tests hold at 1e-4
FLOAT_RTOL = 1e-4


def seeded_quant(tree):
    """The quant collection as JAX's ``init`` on zeros leaves it."""
    def leaf(path, x):
        name = path[-1].key
        if name == "scale":
            return jnp.full(x.shape, 1e-6, jnp.float32)
        if name == "seen":
            return jnp.ones(x.shape, jnp.bool_)
        return jnp.zeros(x.shape, x.dtype) if name == "kernel_q" else jnp.ones(x.shape, x.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


_XLA_CONV = jax.lax.conv_general_dilated


def _split_int8_conv(lhs, rhs, *args, preferred_element_type=None, **kw):
    """An int8 x int8 -> int32 convolution as ``16 conv(hi, w) + conv(lo, w)``
    over the input's halves ``hi = x >> 4`` in [-8, 7] and ``lo = x & 15`` in
    [0, 15], each a float32 convolution whose terms are integers of at most
    15 x 128: exact while ``15 * 128 * K < 2^24`` for a reduction of ``K``
    terms (asserted), whatever the order of the sums. Any other convolution
    is XLA's own."""
    if not (preferred_element_type == jnp.int32 and lhs.dtype == rhs.dtype == jnp.int8
            and kw.get("feature_group_count", 1) == 1 and kw.get("batch_group_count", 1) == 1):
        return _XLA_CONV(lhs, rhs, *args, preferred_element_type=preferred_element_type, **kw)
    k = rhs.size // rhs.shape[kw["dimension_numbers"][1].index("O")]
    assert 15 * 128 * k < 2 ** 24, k
    x, w = lhs.astype(jnp.int32), rhs.astype(jnp.float32)

    def conv(half):
        return _XLA_CONV(half.astype(jnp.float32), w, *args, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST, **kw).astype(jnp.int32)
    return conv(x >> 4) * 16 + conv(x & 15)


@contextlib.contextmanager
def exact_int8_convolutions():
    """JAX's int8 convolutions computed by :func:`_split_int8_conv` within."""
    jax.lax.conv_general_dilated = _split_int8_conv
    try:
        yield
    finally:
        jax.lax.conv_general_dilated = _XLA_CONV


def test_exact_int8_convolution_is_xla_s():
    """The split convolution equals XLA's int8 one bit for bit at the widest
    reduction of the int8 models (3 x 3 x 512: ResNet-50's last stage), with
    the extreme values -128 and 127 in the input, strided and padded."""
    rng = np.random.RandomState(0)
    x = rng.randint(-128, 128, (2, 9, 9, 512)).astype(np.int8)
    x[0, :3] = -128
    x[1, :3] = 127
    w = rng.randint(-127, 128, (3, 3, 512, 24)).astype(np.int8)
    w[:, :, :, 0] = 127
    for strides, padding in (((1, 1), "SAME"), ((2, 2), ((1, 1), (1, 1))), ((1, 1), "VALID")):
        kw = dict(window_strides=strides, padding=padding,
                  dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
        want = jax.jit(lambda x, w: _XLA_CONV(x, w, **kw))(x, w)
        with exact_int8_convolutions():
            got = jax.jit(lambda x, w: jax.lax.conv_general_dilated(x, w, **kw))(x, w)
        assert got.dtype == want.dtype == jnp.int32
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def run_jax(build, variables, batches, x):
    """Calibrate ``build("calibrate")`` on ``batches``, then serve
    ``build("int8")`` on ``x`` and on its ``ROUNDINGS``, the int8
    convolutions through :func:`exact_int8_convolutions`. Returns ``(quant,
    int8 output, its ActQuant outputs, the rounded outputs)``."""
    with exact_int8_convolutions():
        return _run_jax(build, variables, batches, x)


def _run_jax(build, variables, batches, x):
    cal, int8 = build("calibrate"), build("int8")
    quant_state = seeded_quant(jax.eval_shape(cal.init, jax.random.PRNGKey(0),
                                              jnp.asarray(x[:1]))["quant"])
    step = jax.jit(lambda v, q, x: cal.apply({**v, "quant": q}, x, mutable=["quant"])[1])
    for b in batches:
        quant_state = step(variables, quant_state, jnp.asarray(b))["quant"]

    @jax.jit
    def serve(v, q, x):
        out, mut = int8.apply({**v, "quant": q}, x, mutable=["intermediates"],
                              capture_intermediates=lambda m, _: isinstance(m, jq.ActQuant))
        return out, mut["intermediates"]

    out, inter = serve(variables, quant_state, jnp.asarray(x))
    rounded = []
    for s, eps in enumerate(ROUNDINGS):
        noise = np.random.RandomState(s).randn(*x.shape).astype(np.float32) * eps
        rounded.append(jax.tree_util.tree_map(np.asarray,
                                              serve(variables, quant_state, jnp.asarray(x * (1 + noise)))[0]))
    quant_np = jax.tree_util.tree_map(np.asarray, quant_state)
    return quant_np, jax.tree_util.tree_map(np.asarray, out), inter, rounded


def jax_activations(inter, kind):
    """JAX's captured ``ActQuant`` outputs -> ``{port module name: int8 NHWC}``."""
    def strip(tree):
        if "__call__" in tree:
            return {"scale": np.asarray(tree["__call__"][0][0])}
        return {k: strip(v) for k, v in tree.items()}

    return {k[: -len(".scale")]: v for k, v in
            weights.quant_state_dict(strip(inter), kind).items()}


def as_dict(out):
    return out if isinstance(out, dict) else {"out": out}


def run_port(model, float_model, batches, x, jax_quant, kind):
    """The port's calibration (its outputs against the float model's, bit for
    bit), then int8 over JAX's carried state with every ActQuant's output
    recorded. Returns ``(port state, int8 output, {name: int8 NCHW})``."""
    runner = ptq.PTQServing("m", model)
    for b in batches:
        got = as_dict(runner.calibrate(torch.from_numpy(b)))
        with torch.no_grad(), float32_matmuls():
            want = as_dict(float_model(torch.from_numpy(b)))
        for k in want:
            assert torch.equal(got[k], want[k]), k
    state = runner.quant_numpy()
    runner.load_quant(weights.quant_state_dict(jax_quant, kind))
    seen, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, quant.ActQuant):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: seen.__setitem__(name, out[0].clone())))
    try:
        out = runner.serve(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    return state, {k: v.numpy() for k, v in as_dict(out).items()}, seen


def check_state(port_state, jax_quant, kind):
    want = weights.quant_state_dict(jax_quant, kind)
    assert set(port_state) == set(want)
    for k, v in want.items():
        if k.endswith(".scale"):
            assert abs(float(port_state[k]) - float(v)) <= 1e-5 * float(v), k
        else:
            np.testing.assert_array_equal(port_state[k], v, err_msg=k)


def check_flips(port_acts, jax_acts):
    """Quantized activations that differ between the frameworks, counted at
    every ``ActQuant`` in the order the forward reaches them. Where the float
    inputs differ at rounding level, a value within rounding of a step flips
    by one; that flip moves what follows it, so later points differ in more
    places (up to ~10% after the keypoint head's eight convolutions, and by
    2 steps; JAX's own rounded inputs cascade alike). Held: the first point
    that differs at all differs in under 0.1% of its values and by one step,
    and no value anywhere by more than 4 steps (a wrong scale or layout moves
    most values at the first point). Returns ``(differing, total)``."""
    assert set(port_acts) == set(jax_acts)
    total = flipped = 0
    first = None
    for name, got in port_acts.items():          # the order the forward ran them
        d = np.abs(got.permute(0, 2, 3, 1).numpy().astype(np.int32)
                   - jax_acts[name].astype(np.int32))
        assert d.max() <= 4, (name, int(d.max()))
        if first is None and d.any():
            first = name
            assert (d > 0).sum() <= 1e-3 * d.size and d.max() == 1, (name, int((d > 0).sum()))
        total += d.size
        flipped += int((d > 0).sum())
    return flipped, total


def check_outputs(got, want, rounded, keys, rtol=1e-5):
    """Each output within JAX's spread over ``rounded`` plus ``rtol`` of its
    largest magnitude (1 at least)."""
    for k in keys:
        spread = max(np.abs(r[k] - want[k]).max() for r in rounded)
        err = np.abs(got[k] - want[k]).max()
        assert err <= spread + rtol * max(np.abs(want[k]).max(), 1.0), (k, err, spread)


def batches_and_input(seed, shape):
    rng = np.random.RandomState(seed)
    return [rng.rand(*shape).astype(np.float32) for _ in range(2)], rng.rand(*shape).astype(np.float32)


def test_jax_init_seeds_the_floor():
    """JAX's ``PTQServing`` seeds its state with the calibrate twin's ``init``
    on zeros: every scale at the 1e-6 floor with ``seen`` set, the state the
    port's ``seed_calibration`` writes."""
    model = j_embedder.EmbeddingModel(backbone=j_resnet.ResNet(stage_sizes=STAGES), embedding_dim=8)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    runner = j_ptq.PTQServing(
        "e", lambda m: j_embedder.EmbeddingModel(
            backbone=j_resnet.ResNet(stage_sizes=STAGES, quant=m), embedding_dim=8),
        variables["params"], variables["batch_stats"], example=np.zeros((1, 32, 32, 3), np.float32))
    got = weights.quant_state_dict(runner.quant_numpy(), "embedder")
    port = embedder.resnet50_embedder(8, stage_sizes=STAGES, quant="calibrate")
    ptq.PTQServing("e", port)
    ours = quant.quant_state(port)
    assert set(got) == set(ours)
    for k, v in got.items():
        if k.endswith((".scale", ".seen")):
            assert v.item() == ours[k].item(), k


def test_trunk_int8_matches_jax():
    batches, x = batches_and_input(40, (B, IMG, IMG, 3))
    rng = np.random.RandomState(41)
    float_j = j_resnet.ResNet(stage_sizes=STAGES, features_only=True, frozen_stats=True)
    variables = randomize(jax.eval_shape(float_j.init, jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    jq_state, want, inter, rounded = run_jax(
        lambda m: j_resnet.ResNet(stage_sizes=STAGES, features_only=True, frozen_stats=True,
                                  quant=m), variables, batches, x)
    sd = weights.to_tensors(weights.resnet_state_dict(variables["params"], variables["batch_stats"]))
    float_t = resnet.ResNet(STAGES, features_only=True)
    float_t.load_state_dict(sd)
    model = quant.load_float_state_dict(resnet.ResNet(STAGES, features_only=True, quant="calibrate"), sd)
    nchw = [b.transpose(0, 3, 1, 2).copy() for b in batches]
    state, got, acts = run_port(model.eval(), float_t.eval(), nchw, x.transpose(0, 3, 1, 2).copy(),
                                jq_state, "resnet")
    check_state(state, jq_state, "resnet")
    check_flips(acts, jax_activations(inter, "resnet"))
    got = {k: v.transpose(0, 2, 3, 1) for k, v in got.items()}
    check_outputs(got, want, rounded, ("c2", "c3", "c4", "c5"))


def test_embedder_int8_matches_jax():
    batches, x = batches_and_input(50, (B, IMG, IMG, 3))
    rng = np.random.RandomState(51)

    def build(m=None):
        return j_embedder.EmbeddingModel(backbone=j_resnet.ResNet(stage_sizes=STAGES, quant=m),
                                         embedding_dim=512)

    variables = randomize(jax.eval_shape(build().init, jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    jq_state, want, inter, rounded = run_jax(build, variables, batches, x)
    sd = weights.to_tensors(weights.embedder_state_dict(variables))
    float_t = embedder.resnet50_embedder(512, stage_sizes=STAGES)
    float_t.load_state_dict(sd)
    model = quant.load_float_state_dict(
        embedder.resnet50_embedder(512, stage_sizes=STAGES, quant="calibrate"), sd)
    state, got, acts = run_port(model.eval(), float_t.eval(), batches, x, jq_state, "embedder")
    check_state(state, jq_state, "embedder")
    check_flips(acts, jax_activations(inter, "embedder"))
    check_outputs(got, {"out": want}, [{"out": r} for r in rounded], ("out",))


def jax_keypoint_rcnn(q, scope, kp):
    cfg = j_rcnn.RCNNConfig(num_classes=2, num_keypoints=3, box_detections_per_img=1,
                            rpn_pre_nms_top_n_test=PRE, rpn_post_nms_top_n_test=POST)
    body = j_resnet.ResNet(stage_sizes=STAGES, features_only=True, frozen_stats=True, quant=q)
    return j_rcnn.GeneralizedRCNN(
        backbone=j_fpn.BackboneWithFPN(backbone=body,
                                       quant=q if scope in ("fpn", "full") else None),
        cfg=cfg, quant=q if scope in ("rpn", "full") else None, quant_kp=kp)


def check_keypoint_rcnn(monkeypatch, scope, detector, kp):
    """One keypoint R-CNN case: the trunk quantized when ``detector`` (FPN
    and RPN per ``scope``), the keypoint head when ``kp``."""
    monkeypatch.setattr(j_rcnn.GeneralizedRCNN, "DENSE_ROI_ALIGN_MAX_CELLS", 0)
    batches, x = batches_and_input(60, (B, IMG, IMG, 3))
    rng = np.random.RandomState(61)
    variables = randomize(jax.eval_shape(jax_keypoint_rcnn(None, scope, None).init,
                                         jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    jq_state, want, inter, rounded = run_jax(
        lambda m: jax_keypoint_rcnn(m if detector else None, scope, m if kp else None),
        variables, batches, x)
    sd = weights.to_tensors(weights.detection_state_dict(variables))
    budgets = dict(rpn_pre_nms_top_n_test=PRE, rpn_post_nms_top_n_test=POST)
    float_t = rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES, **budgets)
    float_t.load_state_dict(sd)
    model = quant.load_float_state_dict(rcnn.keypointrcnn_resnet50_fpn(
        stage_sizes=STAGES, quant="calibrate" if detector else None, quant_scope=scope,
        quant_kp="calibrate" if kp else None, **budgets), sd)
    state, got, acts = run_port(model.eval(), float_t.eval(), batches, x, jq_state, "detection")
    check_state(state, jq_state, "detection")
    check_flips(acts, jax_activations(inter, "detection"))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    check_outputs(got, want, rounded, ("boxes", "scores", "keypoints", "keypoints_scores"),
                  FLOAT_RTOL)


@pytest.mark.parametrize("scope", ["trunk", "fpn"])
def test_keypoint_rcnn_int8_matches_jax(monkeypatch, scope):
    check_keypoint_rcnn(monkeypatch, scope, True, False)


def test_mobile_quant_kp_matches_jax(monkeypatch):
    monkeypatch.setattr(j_rcnn.GeneralizedRCNN, "DENSE_ROI_ALIGN_MAX_CELLS", 0)
    budgets = dict(rpn_pre_nms_top_n_test=32, rpn_post_nms_top_n_test=8)
    batches, x = batches_and_input(70, (B, IMG, IMG, 3))
    rng = np.random.RandomState(71)
    variables = randomize(jax.eval_shape(j_rcnn.mobile_net_v3_large_keypoint_rcnn(**budgets).init,
                                         jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    jq_state, want, inter, rounded = run_jax(
        lambda m: j_rcnn.mobile_net_v3_large_keypoint_rcnn(quant_kp=m, **budgets),
        variables, batches, x)
    sd = weights.to_tensors(weights.detection_state_dict(variables))
    float_t = rcnn.mobile_net_v3_large_keypoint_rcnn(**budgets)
    float_t.load_state_dict(sd)
    model = quant.load_float_state_dict(
        rcnn.mobile_net_v3_large_keypoint_rcnn(quant_kp="calibrate", **budgets), sd)
    assert all(k.startswith("roi_heads.keypoint_head.") for k in quant.quant_state(model))
    state, got, acts = run_port(model.eval(), float_t.eval(), batches, x, jq_state, "detection")
    check_state(state, jq_state, "detection")
    check_flips(acts, jax_activations(inter, "detection"))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    check_outputs(got, want, rounded, ("boxes", "scores", "keypoints", "keypoints_scores"),
                  FLOAT_RTOL)
