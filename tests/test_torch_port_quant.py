"""The port's int8 quantization primitives (``models/quant.py``) against the
JAX ``models/quant.py`` on the CPU: ``quantize_symmetric`` bit for bit (ties
at .5 included), ``ActQuant``'s running max and ``seen`` flag, ``QuantConv``'s
calibrate snapshot (``weight_q`` bit-equal, ``w_scale`` exact) and its int8
product (the int32 accumulators bit-equal to JAX's
``conv_general_dilated(..., preferred_element_type=int32)``, the dequantized
output within 1e-6), and the zero-padded ``torch._int_mm`` route that the
card takes, against an int64 product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.models import quant as jq
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.models import quant as tq

torch.set_num_threads(1)


def test_quantize_symmetric_bit_equal_with_ties_and_clip():
    rng = np.random.RandomState(0)
    # scale 127 makes 127 / scale exactly 1: x itself is rounded, so .5 ties
    # and the clip at +-127 are hit exactly
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.5, 200.0,
                     -200.0, 0.0], np.float32)
    cases = [(ties, np.float32(127.0)),
             (rng.randn(4096).astype(np.float32) * 3, np.float32(2.7)),
             (rng.randn(1000).astype(np.float32), np.float32(1e-6))]
    for x, s in cases:
        want = np.asarray(jq.quantize_symmetric(jnp.asarray(x), jnp.asarray(s)))
        got = tq.quantize_symmetric(torch.from_numpy(x), torch.tensor(s)).numpy()
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)
    # per-channel weight scales broadcast over the output axis
    w = rng.randn(8, 5, 3, 3).astype(np.float32)
    ws = np.abs(w).max(axis=(1, 2, 3))
    want = np.asarray(jq.quantize_symmetric(jnp.asarray(w.transpose(2, 3, 1, 0)),
                                            jnp.asarray(ws))).transpose(3, 2, 0, 1)
    got = tq.quantize_symmetric(torch.from_numpy(w), torch.from_numpy(ws)[:, None, None, None])
    np.testing.assert_array_equal(got.numpy(), want)


def test_act_quant_running_max_and_seen_flag():
    """The first calibrate batch replaces the initial scale (1.0), later ones
    widen it, the floor is 1e-6; int8 mode quantizes with the scale."""
    rng = np.random.RandomState(1)
    batches = [rng.randn(2, 4, 5, 5).astype(np.float32) * a for a in (0.25, 3.0, 0.5)]
    batches.append(np.zeros((2, 4, 5, 5), np.float32))
    mod = jq.ActQuant(calibrate=True)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(batches[0].transpose(0, 2, 3, 1)))
    # ``init`` already observed batch 0: start again from the initial state
    state = {"scale": jnp.ones((), jnp.float32), "seen": jnp.zeros((), jnp.bool_)}
    assert set(variables["quant"]) == set(state)
    port = tq.ActQuant("calibrate")
    assert float(port.scale) == 1.0 and not bool(port.seen)
    for b in batches:
        _, mut = mod.apply({"quant": state}, jnp.asarray(b.transpose(0, 2, 3, 1)),
                           mutable=["quant"])
        state = mut["quant"]
        out, s = port(torch.from_numpy(b))
        assert out is not None and float(s) == float(state["scale"])
        assert bool(port.seen) == bool(state["seen"])
    zero = tq.ActQuant("calibrate")
    zero(torch.zeros(3))
    assert float(zero.scale) == np.float32(1e-6)
    x = rng.randn(2, 4, 5, 5).astype(np.float32) * 4
    port.mode = "int8"
    xq, s = port(torch.from_numpy(x))
    want, _ = jq.ActQuant(calibrate=False).apply({"quant": state},
                                                 jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(xq.numpy().transpose(0, 2, 3, 1), np.asarray(want))
    with pytest.raises(ValueError):
        tq.ActQuant("int4")


CONVS = [  # (cin, cout, kernel, stride, padding, bias)
    (16, 24, 1, 1, 0, False),
    (16, 24, 1, 2, 0, False),
    (8, 16, 3, 1, 1, True),
    (8, 16, 3, 2, 1, False),
    (5, 12, 3, 1, 1, True),      # K = 45 is not a multiple of 8
]


def _jax_conv(cin, cout, k, stride, pad, bias, calibrate):
    return jq.QuantConv(cout, (k, k), strides=(stride, stride),
                        padding=((pad, pad), (pad, pad)), dtype=jnp.float32,
                        calibrate=calibrate, use_bias=bias)


@pytest.mark.parametrize("cin,cout,k,stride,pad,bias", CONVS)
def test_quant_conv_calibrate_and_int8_match_jax(cin, cout, k, stride, pad, bias):
    rng = np.random.RandomState(cin * 100 + cout + k + stride)
    x = rng.randn(2, cin, 9, 11).astype(np.float32)
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    cal = _jax_conv(cin, cout, k, stride, pad, bias, True)
    params = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32) * 0.3,
        cal.init(jax.random.PRNGKey(0), x_nhwc)["params"])
    y_cal, mut = cal.apply({"params": params}, x_nhwc, mutable=["quant"])

    port = tq.QuantConv(cin, cout, k, stride, pad, bias=bias, mode="calibrate",
                        dtype=torch.float32)
    sd = {"weight": weights._conv(params["kernel"])}
    if bias:
        sd["bias"] = np.asarray(params["bias"])
    tq.load_float_state_dict(port, weights.to_tensors(sd))
    with torch.no_grad():
        y = port(torch.from_numpy(x))
    # the calibrate forward is the float convolution
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1), np.asarray(y_cal),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port.weight_q.numpy(), weights._conv(mut["quant"]["kernel_q"]))
    np.testing.assert_array_equal(port.w_scale.numpy(), np.asarray(mut["quant"]["w_scale"]))

    # int8 on identical inputs and carried state
    s_x = np.float32(2.5)
    xq = rng.randint(-127, 128, size=(2, cin, 9, 11)).astype(np.int8)
    xq_nhwc = jnp.asarray(xq.transpose(0, 2, 3, 1))
    int8 = _jax_conv(cin, cout, k, stride, pad, bias, False)
    want = int8.apply({"params": params, "quant": mut["quant"]}, xq_nhwc, jnp.asarray(s_x))
    acc_want = jax.lax.conv_general_dilated(
        xq_nhwc, mut["quant"]["kernel_q"], (stride, stride), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    port.mode = "int8"
    xt = torch.from_numpy(xq)
    acc = tq.int8_conv2d_acc(xt, port.weight_q, port.stride, port.padding)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_want))
    with torch.no_grad():
        got = port(xt, torch.tensor(s_x)).numpy().transpose(0, 2, 3, 1)
    want = np.asarray(want)
    assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(), 1.0)
    with pytest.raises(TypeError):
        port(torch.from_numpy(x), torch.tensor(s_x))


@pytest.mark.parametrize("M,K,N", [(1, 64, 8), (16, 45, 24), (5, 7, 3), (40, 2304, 512)])
def test_padded_int_mm_equals_int64_product(M, K, N):
    """The one route, on every device: rows padded past 16, K and N to
    multiples of 8, with zeros; the int32 product equals an int64 one
    exactly, at shapes that need each padding and at an aligned one."""
    g = torch.Generator().manual_seed(M + K + N)
    a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
    want = a.long() @ b.long().t()
    got = tq.int_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got.long(), want)
    # worst case of the widest contraction: every product 127 * 127
    full = torch.full((17, 4608), 127, dtype=torch.int8)
    assert int(tq.int_mm(full, full[:8])[0, 0]) == 4608 * 127 * 127


def test_im2col_one_by_one_is_a_view_of_channels_last():
    x = torch.randint(-127, 128, (2, 16, 6, 6), dtype=torch.int8)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    cols, Ho, Wo = tq.im2col(x_cl, (1, 1), (1, 1), (0, 0))
    assert (Ho, Wo) == (6, 6) and cols.data_ptr() == x_cl.data_ptr()
    assert torch.equal(cols, x.permute(0, 2, 3, 1).reshape(-1, 16))


def test_float_state_dict_loads_into_quant_twin_and_nothing_else():
    conv = torch.nn.Conv2d(4, 8, 3, padding=1)
    twin = tq.QuantConv(4, 8, 3, padding=1, mode="int8")
    tq.load_float_state_dict(twin, conv.state_dict())
    assert torch.equal(twin.weight, conv.weight)
    assert set(tq.quant_state(twin)) == {"weight_q", "w_scale"}
    with pytest.raises(KeyError):
        tq.load_float_state_dict(twin, {"weight": conv.weight})
