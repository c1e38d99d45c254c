"""The small trunks of the port (``models.resnet``: ``BasicBlock``,
``resnet18``, ``resnet34``; ``models.mobilenet_v3.mobilenet_v3_large``)
against the JAX package's on the CPU, on randomised JAX variables carried
over by ``weights.py`` (``resnet_state_dict`` with basic blocks,
``mobilenet_state_dict``).

Float32 at B = 2 of 64 x 64 (JAX's space-to-depth stem; the port's plain
one on the same kernel): the features and logits within 1e-4 relative to
their largest value, in eval mode over frozen and over live statistics; one
live-BatchNorm training forward (flax momentum 0.9) within 1e-4, its new
running statistics within 1e-5 relative in norm. The int8 twin of
``resnet18`` (the ``quant`` contract: ``in_q`` and ``q1`` a block) is
calibrated and served as ``test_torch_port_quant_models.py`` holds
ResNet-50's: the calibrated state equal, activation flips within its
bounds, the outputs within JAX's own spread under input rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.models import mobilenet_v3 as j_mbv3
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.models import (BasicBlock, mobilenet_v3_large, resnet18,
                                                    resnet34)
from pets_face_recognition_tpu_torch.models import quant
from pets_face_recognition_tpu_torch.models.mobilenet_v3 import MobileNetV3Large
from pets_face_recognition_tpu_torch.models.resnet import FrozenBatchNorm2d, LiveBatchNorm2d

from test_torch_port_models import randomize, rel_err
from test_torch_port_quant_models import (batches_and_input, check_flips, check_outputs,
                                          check_state, jax_activations, run_jax, run_port)

torch.set_num_threads(1)

B, IMG = 2, 64
FACTORIES = {"resnet18": (j_resnet.resnet18, resnet18, (2, 2, 2, 2)),
             "resnet34": (j_resnet.resnet34, resnet34, (3, 4, 6, 3))}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def carried(j_model, port, x, seed):
    variables = randomize(jax.eval_shape(j_model.init, jax.random.PRNGKey(0), jnp.asarray(x)),
                          np.random.RandomState(seed))
    port.load_state_dict(weights.to_tensors(weights.resnet_state_dict(
        variables["params"], variables["batch_stats"])), strict=True)
    return variables


@pytest.mark.parametrize("arch", sorted(FACTORIES))
def test_small_resnet_features_match_jax(arch):
    """``features_only`` over frozen statistics: c2..c5 (64, 128, 256, 512
    wide) within 1e-4; each block is a ``BasicBlock``, the stages' sizes
    JAX's."""
    j_factory, factory, stages = FACTORIES[arch]
    x = np.random.RandomState(1).rand(B, IMG, IMG, 3).astype(np.float32)
    j_model = j_factory(features_only=True, frozen_stats=True)
    port = factory(features_only=True, frozen_stats=True)
    variables = carried(j_model, port, x, 2)
    assert [len(getattr(port, f"layer{i}")) for i in range(1, 5)] == list(stages)
    assert all(isinstance(m, BasicBlock) for i in range(1, 5) for m in getattr(port, f"layer{i}"))
    assert all(not isinstance(m, LiveBatchNorm2d) for m in port.modules())
    want = jax.jit(j_model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(nchw(x))
    assert sorted(got) == ["c2", "c3", "c4", "c5"]
    for k, c in zip(sorted(got), port.level_channels):
        assert got[k].shape[1] == c
        assert rel_err(got[k].permute(0, 2, 3, 1), want[k]) < 1e-4, k


@pytest.mark.parametrize("arch", sorted(FACTORIES))
def test_small_resnet_logits_match_jax(arch):
    """The classifier (live norms, eval: running statistics) within 1e-4."""
    j_factory, factory, _ = FACTORIES[arch]
    x = np.random.RandomState(3).rand(B, IMG, IMG, 3).astype(np.float32)
    j_model, port = j_factory(num_classes=10), factory(num_classes=10)
    variables = carried(j_model, port, x, 4)
    assert any(isinstance(m, LiveBatchNorm2d) for m in port.modules())
    want = jax.jit(j_model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(nchw(x))
    assert got.shape == (B, 10)
    assert rel_err(got, want) < 1e-4


def test_resnet18_live_batchnorm_training_forward_matches_jax():
    """A training forward of the live-BN ``resnet18``: logits within 1e-4, and
    every running mean and variance after it within 1e-5 (relative in norm)
    of JAX's ``mutable=["batch_stats"]``, each of them moved."""
    x = np.random.RandomState(5).rand(B, IMG, IMG, 3).astype(np.float32)
    j_model, port = j_resnet.resnet18(num_classes=10), resnet18(num_classes=10)
    variables = carried(j_model, port, x, 6)
    want, mutated = jax.jit(lambda v, x: j_model.apply(v, x, train=True,
                                                       mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    before = {n: b.clone() for n, b in port.named_buffers()}
    with torch.no_grad():
        got = port.train()(nchw(x))
    assert rel_err(got, want) < 1e-4
    want_sd = weights.resnet_state_dict(variables["params"], mutated["batch_stats"])
    for n, b in port.named_buffers():
        w = want_sd[n]
        assert np.linalg.norm(b.numpy() - w) <= 1e-5 * np.linalg.norm(w), n
        assert not torch.equal(b, before[n]), n


def test_resnet18_int8_twin_matches_jax():
    """``resnet18(features_only, frozen_stats, quant=...)``: the calibrate twin
    equals the float model bit for bit, its state JAX's; the int8 twin on
    JAX's state within JAX's spread."""
    batches, x = batches_and_input(42, (B, IMG, IMG, 3))
    j_float = j_resnet.resnet18(features_only=True, frozen_stats=True)
    variables = randomize(jax.eval_shape(j_float.init, jax.random.PRNGKey(0), jnp.asarray(x)),
                          np.random.RandomState(43))
    jq_state, want, inter, rounded = run_jax(
        lambda m: j_resnet.resnet18(features_only=True, frozen_stats=True, quant=m),
        variables, batches, x)
    sd = weights.to_tensors(weights.resnet_state_dict(variables["params"],
                                                      variables["batch_stats"]))
    float_t = resnet18(features_only=True, frozen_stats=True)
    float_t.load_state_dict(sd, strict=True)
    model = quant.load_float_state_dict(
        resnet18(features_only=True, frozen_stats=True, quant="calibrate"), sd)
    assert all(hasattr(m, "in_q") and hasattr(m, "q1") for m in model.modules()
               if isinstance(m, BasicBlock))
    nchw_b = [b.transpose(0, 3, 1, 2).copy() for b in batches]
    state, got, acts = run_port(model.eval(), float_t.eval(), nchw_b,
                                x.transpose(0, 3, 1, 2).copy(), jq_state, "resnet")
    check_state(state, jq_state, "resnet")
    check_flips(acts, jax_activations(inter, "resnet"))
    got = {k: v.transpose(0, 2, 3, 1) for k, v in got.items()}
    check_outputs(got, want, rounded, ("c2", "c3", "c4", "c5"))


@pytest.mark.parametrize("kw", [dict(features_only=True, frozen_stats=True),
                                dict(num_classes=10)], ids=["features", "classifier"])
def test_mobilenet_v3_large_factory_matches_jax(kw):
    """``mobilenet_v3_large(**kw)`` builds what JAX's factory does: the taps
    or the logits within 1e-4."""
    x = np.random.RandomState(7).rand(B, IMG, IMG, 3).astype(np.float32)
    j_model, port = j_mbv3.mobilenet_v3_large(**kw), mobilenet_v3_large(**kw)
    assert isinstance(port, MobileNetV3Large)
    variables = randomize(jax.eval_shape(j_model.init, jax.random.PRNGKey(0), jnp.asarray(x)),
                          np.random.RandomState(8))
    port.load_state_dict(weights.to_tensors(weights.mobilenet_state_dict(
        variables["params"], variables["batch_stats"])), strict=True)
    norms = {type(m) for m in port.modules() if isinstance(m, (FrozenBatchNorm2d,
                                                                LiveBatchNorm2d))}
    assert norms == {FrozenBatchNorm2d if kw.get("frozen_stats") else LiveBatchNorm2d}
    want = jax.jit(j_model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(nchw(x))
    if isinstance(want, dict):
        for k in want:
            assert rel_err(got[k].permute(0, 2, 3, 1), want[k]) < 1e-4, k
    else:
        assert got.shape == (B, 10) and rel_err(got, want) < 1e-4
