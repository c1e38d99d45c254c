"""The int8 twins computing in bfloat16 against the JAX package's on the
CPU: ``QuantConv`` and ``ActQuant`` at ``dtype=bfloat16`` (JAX's default),
the keypoint head's int8 chain of a bfloat16 keypoint R-CNN (JAX's serving
bench: ``--int8-kp-head`` on the bfloat16 detector), and a whole bfloat16
detector's calibrate and int8 forwards with the trunk and RPN quantized too.

Rounding points (JAX ``models/quant.py:119-143``): the calibrate forward is
the bfloat16 convolution, its bias added in bfloat16; ``ActQuant`` reads the
max-abs of the bfloat16 activation (exact in float32); the int8 product sums
in int32, exactly; dequantization and bias in float32, then one cast to
bfloat16. So the int32 sums are bit-equal on equal int8 inputs, and the
epilogue is the same float32 arithmetic rounded once. JAX's int8
convolutions run as two exact float32 convolutions on the CPU
(``test_torch_port_quant_models.exact_int8_convolutions``: XLA's CPU int8
convolution is slow).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import quant as jq
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.device import float32_matmuls
from pets_face_recognition_tpu_torch.models import ptq, quant as tq, rcnn

from test_torch_port_models import randomize
from test_torch_port_quant import CONVS
from test_torch_port_quant_models import exact_int8_convolutions, seeded_quant

torch.set_num_threads(1)

BF, T_BF = jnp.bfloat16, torch.bfloat16
STAGES = (1, 1, 1, 1)
# one bfloat16 layer (test_torch_port_bf16_models.py): relative L2; a chain
LAYER_L2, CHAIN_L2 = 4e-3, 2e-2


def l2(got, want) -> float:
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def bf16_steps_apart(got: torch.Tensor, want) -> int:
    """The most bfloat16 steps between two bfloat16 arrays, elementwise."""
    a = got.view(torch.int16).numpy().astype(np.int32)
    b = np.asarray(want).view(np.int16).astype(np.int32)
    # sign-magnitude bits to an ordered integer line
    a = np.where(a < 0, -(a & 0x7FFF), a)
    b = np.where(b < 0, -(b & 0x7FFF), b)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("cin,cout,k,stride,pad,bias", CONVS)
def test_quant_conv_bf16_matches_jax(cin, cout, k, stride, pad, bias):
    """Calibrate: the bfloat16 convolution within one layer's tolerance, its
    snapshot exact. int8: the int32 sums bit-equal, the output bfloat16 and
    within one bfloat16 step of JAX's (the same float32 epilogue, which XLA
    may fuse into a multiply-add)."""
    rng = np.random.RandomState(cin * 100 + cout + k + stride)
    x = rng.randn(2, cin, 9, 11).astype(np.float32)
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    kw = dict(strides=(stride, stride), padding=((pad, pad), (pad, pad)), use_bias=bias)
    cal = jq.QuantConv(cout, (k, k), calibrate=True, **kw)
    assert cal.dtype == BF
    params = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32) * 0.3,
                                    cal.init(jax.random.PRNGKey(0), x_nhwc)["params"])
    y_cal, mut = cal.apply({"params": params}, x_nhwc.astype(BF), mutable=["quant"])

    port = tq.QuantConv(cin, cout, k, stride, pad, bias=bias, mode="calibrate")
    assert port.compute_dtype == T_BF
    sd = {"weight": weights._conv(params["kernel"])}
    if bias:
        sd["bias"] = np.asarray(params["bias"])
    tq.load_float_state_dict(port, weights.to_tensors(sd))
    with torch.no_grad():
        y = port(torch.from_numpy(x).to(T_BF))
    assert y.dtype == T_BF and y_cal.dtype == BF
    assert l2(y.permute(0, 2, 3, 1), y_cal) <= LAYER_L2
    np.testing.assert_array_equal(port.weight_q.numpy(), weights._conv(mut["quant"]["kernel_q"]))
    np.testing.assert_array_equal(port.w_scale.numpy(), np.asarray(mut["quant"]["w_scale"]))

    s_x = np.float32(2.5)
    xq = rng.randint(-127, 128, size=(2, cin, 9, 11)).astype(np.int8)
    xq_nhwc = jnp.asarray(xq.transpose(0, 2, 3, 1))
    with exact_int8_convolutions():
        want = jq.QuantConv(cout, (k, k), **kw).apply(
            {"params": params, "quant": mut["quant"]}, xq_nhwc, jnp.asarray(s_x))
    port.mode = "int8"
    xt = torch.from_numpy(xq)
    acc = tq.int8_conv2d_acc(xt, port.weight_q, port.stride, port.padding)
    acc_want = jax.lax.conv_general_dilated(
        xq_nhwc.astype(jnp.float32), mut["quant"]["kernel_q"].astype(jnp.float32),
        (stride, stride), ((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_want).astype(np.int32))
    with torch.no_grad():
        got = port(xt, torch.tensor(s_x)).permute(0, 2, 3, 1).contiguous()
    assert got.dtype == T_BF and want.dtype == BF
    assert bf16_steps_apart(got, want) <= 1


def test_act_quant_reads_the_bf16_activation():
    """``ActQuant`` on a bfloat16 activation: the calibrated max-abs and the
    int8 values equal JAX's bit for bit (the bfloat16 values are exact in
    float32)."""
    x = np.random.RandomState(4).randn(2, 6, 5, 8).astype(np.float32) * 3
    xb = jnp.asarray(x).astype(BF)
    j_cal, j_int8 = jq.ActQuant(calibrate=True), jq.ActQuant()
    v = jax.tree_util.tree_map(lambda a: a, j_cal.init(jax.random.PRNGKey(0), xb))
    (_, s), mut = j_cal.apply(v, xb, mutable=["quant"])
    want_q, _ = j_int8.apply(mut, xb)
    port = tq.ActQuant("calibrate")
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32)).transpose(0, 3, 1, 2)).to(T_BF)
    out, scale = port(xt)
    assert out is xt and float(scale) == float(s)
    port.mode = "int8"
    q, _ = port(xt)
    np.testing.assert_array_equal(q.permute(0, 2, 3, 1).numpy(), np.asarray(want_q))


def jax_detector(dtype, quant_kp=None, quant=None):
    cfg = j_rcnn.RCNNConfig(num_classes=2, num_keypoints=3, box_detections_per_img=1,
                            rpn_pre_nms_top_n_test=32, rpn_post_nms_top_n_test=8)
    body = j_resnet.ResNet(stage_sizes=STAGES, features_only=True, frozen_stats=True,
                           dtype=dtype, quant=quant)
    return j_rcnn.GeneralizedRCNN(backbone=j_fpn.BackboneWithFPN(backbone=body, dtype=dtype),
                                  cfg=cfg, dtype=dtype, quant=quant, quant_kp=quant_kp)


def _heatmaps(m, x):
    """The keypoint head and its predictor on pooled NHWC RoIs (a flax method)."""
    return m.keypoint_head(x)


def test_int8_keypoint_head_on_a_bf16_detector():
    """The keypoint head's int8 chain in a bfloat16 keypoint R-CNN, on pooled
    RoIs as the bfloat16 detector's K3 gives them (float32): the calibrate
    heatmaps within the chain tolerance of JAX's and the calibrated scales
    within a bfloat16 step (2^-7 relative: each is the max-abs of a bfloat16
    activation). Then int8 over JAX's carried state: the first point's int8
    input equal, every quantized activation of the chain within one int8 step
    of JAX's, and the heatmaps within the chain tolerance."""
    rng = np.random.RandomState(5)
    pooled = [rng.randn(4, 14, 14, 256).astype(np.float32) for _ in range(3)]
    j_cal, j_int8 = jax_detector(BF, "calibrate"), jax_detector(BF, "int8")
    x0 = jnp.zeros((1, 64, 64, 3))
    variables = randomize(jax.eval_shape(jax_detector(BF).init, jax.random.PRNGKey(0), x0),
                          np.random.RandomState(6))
    q0 = seeded_quant(jax.eval_shape(j_cal.init, jax.random.PRNGKey(0), x0)["quant"])
    cal_step = jax.jit(lambda v, q, x: j_cal.apply({**v, "quant": q}, x, method=_heatmaps,
                                                   mutable=["quant"]))
    j_heat, q = [], q0
    for p in pooled[:2]:
        h, mut = cal_step(variables, q, jnp.asarray(p))
        q = mut["quant"]
        j_heat.append(h)
    with exact_int8_convolutions():
        j_served, inter = jax.jit(lambda v, q, x: j_int8.apply(
            {**v, "quant": q}, x, method=_heatmaps, mutable=["intermediates"],
            capture_intermediates=lambda m, _: isinstance(m, jq.ActQuant)))(
                variables, q, jnp.asarray(pooled[2]))

    det = rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES, quant_kp="calibrate", dtype=T_BF)
    tq.load_float_state_dict(det, weights.to_tensors(weights.detection_state_dict(variables)))
    tq.seed_calibration(det.eval())
    heads = det.roi_heads

    def port_heat(p):
        x = torch.from_numpy(p).permute(0, 3, 1, 2)
        with torch.no_grad(), float32_matmuls():
            return heads.keypoint_predictor(heads.keypoint_head(x))

    for p, want in zip(pooled[:2], j_heat):
        got = port_heat(p)
        assert got.dtype == torch.float32
        assert l2(got, want) <= CHAIN_L2
    state = {k: v.numpy() for k, v in tq.quant_state(det).items()}
    want_state = weights.quant_state_dict(jax.tree_util.tree_map(np.asarray, q))
    assert set(state) == set(want_state)
    for k, v in want_state.items():
        if k.endswith(".scale"):
            assert abs(float(state[k]) - float(v)) <= 2.0 ** -7 * float(v), k
        else:
            np.testing.assert_array_equal(state[k], v, err_msg=k)

    # int8 over JAX's state, carried by weights.quant_state_dict
    runner = ptq.PTQServing("det", det)
    runner.load_quant(want_state)
    tq.set_quant_mode(det, "int8")
    seen = []
    hooks = [m.register_forward_hook(lambda mod, i, o: seen.append(o[0].clone()))
             for m in heads.keypoint_head.kps_q]
    try:
        got = port_heat(pooled[2])
    finally:
        for h in hooks:
            h.remove()
    j_acts = inter["intermediates"]["keypoint_head"]
    j_acts = [np.asarray(j_acts[f"kps_q{i + 1}"]["__call__"][0][0]) for i in range(8)]
    assert len(seen) == 8
    assert np.array_equal(seen[0].permute(0, 2, 3, 1).numpy(), j_acts[0])
    for a, b in zip(seen, j_acts):
        assert np.abs(a.permute(0, 2, 3, 1).numpy().astype(np.int32)
                      - b.astype(np.int32)).max() <= 1
    assert l2(got, j_served) <= CHAIN_L2


def test_bf16_int8_detector_calibrates_and_serves():
    """A bfloat16 keypoint R-CNN with the trunk and RPN at scope ``rpn`` and
    the keypoint head quantized, through ``PTQServing``: the calibrate forward
    is the float bfloat16 detector's, bit for bit; the int8 forward gives
    finite detections of the same shapes, its int8 convolutions in bfloat16."""
    x = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32)
    budgets = dict(rpn_pre_nms_top_n_test=32, rpn_post_nms_top_n_test=8)
    float_t = rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES, dtype=T_BF, **budgets)
    weights.init_random_(float_t, 3)
    model = tq.load_float_state_dict(rcnn.keypointrcnn_resnet50_fpn(
        stage_sizes=STAGES, quant="calibrate", quant_kp="calibrate", dtype=T_BF, **budgets),
        float_t.state_dict())
    convs = [m for m in model.modules() if isinstance(m, tq.QuantConv)]
    assert convs and {m.compute_dtype for m in convs} == {T_BF}
    runner = ptq.PTQServing("det", model.eval())
    cal = runner.calibrate(torch.from_numpy(x))
    with torch.no_grad(), float32_matmuls():
        want = float_t.eval()(torch.from_numpy(x))
    for k in want:
        assert torch.equal(cal[k], want[k]), k
    served = runner.serve(torch.from_numpy(x))
    for k in want:
        assert served[k].shape == want[k].shape and served[k].dtype == want[k].dtype, k
        if served[k].is_floating_point():
            assert torch.isfinite(served[k]).all(), k
