"""One feature-extractor training step of the port (``engine.controller.
Controller.train_step``: the ResNet embedder with live BatchNorm, ArcFace s 64
m 0.5, the focal loss, then the FE SGD in three groups or AdamW) against the
JAX package's ``Controller.make_train_step`` on the CPU, on the same weights
and batch.

Sizes: the embedder cut to one bottleneck a stage at production width (512-d
embedding), B = 4 crops of 64 x 64, C = 8 classes. Also ROADMAP fault 13: the
port's embedder normalises with live statistics in ``train()`` and moves its
running statistics as flax's ``BatchNorm(momentum=0.9)`` does.
"""

import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.engine.controller import Controller as JController
from pets_face_recognition_tpu.engine.train_state import TrainState as JTrainState
from pets_face_recognition_tpu.losses import SoftmaxBasedMetricLearning as JWrapper
from pets_face_recognition_tpu.models import embedder as j_embedder
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.utils.optim import (fe_adamw_optimizer as j_adamw,
                                                   fe_sgd_optimizer as j_sgd,
                                                   wrap_gradient_transform)
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.engine.controller import Controller
from pets_face_recognition_tpu_torch.losses import SoftmaxBasedMetricLearning
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
from pets_face_recognition_tpu_torch.models.resnet import LiveBatchNorm2d
from pets_face_recognition_tpu_torch.utils import DictWrapper
from pets_face_recognition_tpu_torch.utils.optim import (fe_adamw_optimizer, fe_param_group,
                                                         fe_sgd_optimizer)

from test_torch_port_models import randomize

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
B, IMG, C, D = 4, 64, 8, 512
LR = {"sgd": 1e-2, "adamw": 1e-4}
GROUP_LR = {"backbone": 0.5, "fc": 1.0, "margin": 1.0}
# the input rounding of JAX's own gradient spread: below the two frameworks'
# own forward disagreement (~2e-5 relative at the last stage's norms)
INPUT_ROUNDING = 1e-6


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def port_wrapper(variables=None) -> SoftmaxBasedMetricLearning:
    model = SoftmaxBasedMetricLearning(resnet50_embedder(D, stage_sizes=STAGES), D, C)
    if variables is not None:
        model.load_state_dict(weights.to_tensors(weights.fe_state_dict(variables)), strict=True)
    return model


@pytest.fixture(scope="module")
def steps():
    rng = np.random.RandomState(3)
    batch = {"x": rng.rand(B, IMG, IMG, 3).astype(np.float32),
             "label": rng.randint(0, C, B).astype(np.int32),
             "index": np.arange(B, dtype=np.int32)}
    j_model = JWrapper(model=j_embedder.EmbeddingModel(
        backbone=j_resnet.ResNet(stage_sizes=STAGES), embedding_dim=D), emb_size=D,
        num_classes=C, margin_type="arc", use_focal=True)
    x = jnp.asarray(batch["x"])
    labels = jnp.asarray(batch["label"])
    variables = randomize(jax.eval_shape(j_model.init, jax.random.PRNGKey(0), x, labels),
                          np.random.RandomState(23))
    variables = jax.tree.map(np.asarray, variables)

    @jax.jit
    def grad_fn(params, x):
        def loss_fn(p):
            out, _ = j_model.apply({"params": p, "batch_stats": variables["batch_stats"]}, x,
                                   labels, train=True, mutable=["batch_stats"])
            return out["loss"], out
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, j_out), j_grads = grad_fn(variables["params"], x)
    # JAX against itself: the same step on inputs changed by 1e-6 relative,
    # three draws (see test_fe_step_gradients_match_jax)
    j_spread = [weights.fe_state_dict({"params": grad_fn(variables["params"], x * (
        1 + jnp.asarray(np.random.RandomState(s).randn(*x.shape), jnp.float32) * INPUT_ROUNDING
    ))[1]}) for s in (1, 2, 3)]

    out = {"batch": batch, "variables": variables, "j_out": j_out, "j_spread": j_spread,
           "j_grads": weights.fe_state_dict({"params": j_grads})}
    config = types.SimpleNamespace(model=lambda: None, loss=lambda c, m: j_model)
    for kind in ("sgd", "adamw"):
        tx = j_sgd(LR["sgd"]) if kind == "sgd" else j_adamw(LR["adamw"])
        ctl = JController(config)
        j_state = JTrainState.create(j_model.apply, jax.tree.map(jnp.array, variables),
                                     wrap_gradient_transform(tx))
        j_new, j_metrics = ctl.make_train_step()(
            j_state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
        factory = (partial(fe_sgd_optimizer, lr=LR["sgd"]) if kind == "sgd"
                   else partial(fe_adamw_optimizer, lr=LR["adamw"]))
        t_ctl = Controller(DictWrapper({"optimizer": lambda c, f=factory: f}))
        model = port_wrapper(variables)
        state = t_ctl.init_state(0, "cpu", model=model)
        before = {n: b.clone() for n, b in model.named_buffers()}
        metrics = t_ctl.train_step(state, batch)
        out[kind] = dict(model=model, state=state, before=before, metrics=metrics,
                         j_metrics=jax.device_get(j_metrics),
                         j_new=weights.fe_state_dict({"params": j_new.params,
                                                      "batch_stats": j_new.batch_stats}))
    return out


def test_fe_wrapper_forward_matches_jax(steps):
    """The port's wrapper in ``train()`` on the JAX variables: the loss 1e-4
    relative, embeddings and margin logits 1e-4 relative to their largest."""
    model = port_wrapper(steps["variables"]).train()
    b = steps["batch"]
    with torch.no_grad():
        out = model(torch.from_numpy(b["x"]), torch.from_numpy(b["label"]).long())
    j = steps["j_out"]
    assert abs(float(out["loss"]) - float(j["loss"])) <= 1e-4 * abs(float(j["loss"]))
    for k in ("emb", "logits"):
        got, want = out[k].numpy(), np.asarray(j[k])
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), k


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_fe_step_loss_and_accuracy_match_jax(steps, kind):
    """``loss`` within 1e-4 relative and ``train_acc`` equal."""
    got, want = steps[kind]["metrics"], steps[kind]["j_metrics"]
    assert abs(got["loss"] - float(want["loss"])) <= 1e-4 * abs(float(want["loss"]))
    assert got["train_acc"] == float(want["train_acc"])
    assert np.isfinite(got["loss"])


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_fe_step_gradients_match_jax(steps, kind):
    """Every parameter's gradient against JAX's, held to JAX's own float32
    spread (ROADMAP §3 note 9): the worst and the median tensor within 1e-3
    relative in norm, or else within the largest worst and median of JAX
    against itself on inputs changed by 1e-6 relative (three draws). The
    step is ill-conditioned in float32: the two frameworks' forwards differ
    by ~2e-5 relative at the last stage, where live BatchNorm sees 64 values
    a channel, and that flips the ReLU of activations within ~1e-4 of 0 (one
    of 32768 at ``layer4.0.bn1``, the rest matching to 1e-5), which moves a
    trunk gradient by up to ~1e-2. 1e-7 input rounding flips such a ReLU in
    only some draws, 1e-6 in every one."""
    grads = {n: p.grad.numpy() for n, p in steps[kind]["model"].named_parameters()}
    assert sorted(grads) == sorted(steps["j_grads"])
    errs = {n: _rel(grads[n], steps["j_grads"][n]) for n in grads}
    spreads = [[_rel(d[n], steps["j_grads"][n]) for n in grads] for d in steps["j_spread"]]
    worst_bound = max(1e-3, max(max(s) for s in spreads))
    median_bound = max(1e-3, max(float(np.median(s)) for s in spreads))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= worst_bound, (worst, errs[worst], worst_bound)
    assert np.median(list(errs.values())) <= median_bound, median_bound
    # the trunk's top (after the last live norm) is well conditioned: 1e-4
    for n in ("model.fc.weight", "model.fc.bias", "add_margin.weight"):
        assert errs[n] <= 1e-4, (n, errs[n])


def _update(kind: str, name: str, g: np.ndarray, p: np.ndarray) -> np.ndarray:
    """The first step's update of a parameter from its gradient (momentum and
    Adam's moments start at 0)."""
    if kind == "sgd":
        group = fe_param_group(name)
        wd = 1e-4 if group == "margin" else 0.0
        return -LR["sgd"] * GROUP_LR[group] * (g + wd * p)
    return -LR["adamw"] * (g / (np.abs(g) + 1e-8) + 1e-4 * p)


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_fe_step_parameters_match_jax(steps, kind):
    """Every parameter after the step (SGD: backbone at lr/2, ``fc`` at lr,
    the margin head at lr with weight decay 1e-4; AdamW: eps 1e-8, decay
    1e-4 scaled by the rate): 1e-5 relative in norm once the step's own
    gradient difference is taken out (``p_port + u(g_jax) - u(g_port)``)."""
    params = dict(steps[kind]["model"].named_parameters())
    before = weights.fe_state_dict(steps["variables"])
    errs = {}
    for n, p in params.items():
        p0 = before[n]
        moved = (p.detach().numpy() + _update(kind, n, steps["j_grads"][n], p0)
                 - _update(kind, n, p.grad.numpy(), p0))
        errs[n] = _rel(moved, steps[kind]["j_new"][n])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_fe_step_running_statistics_match_jax_fault_13(steps, kind):
    """ROADMAP fault 13: every running mean and variance after the step
    against the JAX step's new ``batch_stats`` (momentum 0.9, biased batch
    variance): 1e-5 relative in norm, and each of them moved."""
    buffers = dict(steps[kind]["model"].named_buffers())
    assert sorted(buffers) == sorted(k for k in steps[kind]["j_new"]
                                     if k.endswith(("running_mean", "running_var")))
    errs = {n: _rel(b, steps[kind]["j_new"][n]) for n, b in buffers.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])
    assert all(not torch.equal(b, steps[kind]["before"][n]) for n, b in buffers.items())


def test_embedder_norms_are_live_at_flax_momentum():
    """The embedder is built with ``LiveBatchNorm2d`` at momentum 0.9 (no
    ``nn.BatchNorm2d``, no ``num_batches_tracked``), and the SGD groups follow
    the JAX ``_label_fn``."""
    model = port_wrapper()
    norms = [m for m in model.modules() if isinstance(m, LiveBatchNorm2d)]
    assert norms and all(m.momentum == 0.9 and m.eps == 1e-5 for m in norms)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert not any("num_batches_tracked" in k for k in model.state_dict())
    groups = {n: fe_param_group(n) for n, _ in model.named_parameters()}
    assert groups["add_margin.weight"] == "margin"
    assert groups["model.fc.weight"] == groups["model.fc.bias"] == "fc"
    assert groups["model.bn1.weight"] == groups["model.layer4.0.conv3.weight"] == "backbone"
    opt, schedule = fe_sgd_optimizer(model, lr=0.1, milestones_steps=[3])
    assert [(g["lr"], g["weight_decay"], g["momentum"]) for g in opt.param_groups] == [
        (0.05, 0.0, 0.9), (0.1, 0.0, 0.9), (0.1, 1e-4, 0.9)]
    assert schedule(2) == 0.1 and abs(schedule(3) - 0.01) < 1e-15
