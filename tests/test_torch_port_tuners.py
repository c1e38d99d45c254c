"""The port's tuners (``utils/tuners.py``) against the JAX package's on the CPU.

- ``find_max_batch_size``: stub controllers that run out of memory above a
  batch size, the port's raising ``torch.cuda.OutOfMemoryError`` and JAX's
  twin an ``XlaRuntimeError``-style ``RESOURCE_EXHAUSTED``, find the same
  batch (every start, trial count and limit below); any other error
  propagates, a ``RuntimeError`` that only says "out of memory" included.
- ``find_optimal_init_lr``: a small FE task (the embedder cut to one block a
  stage, 64-d, B = 4 of 64 x 64, 6 classes) on JAX's initial weights, 12
  steps from 1e-5 to 1: the rate it returns equal to JAX's, the sweep's
  length and rates equal, and each step's loss within 1e-4 relative of
  JAX's while the rate is below 3e-4 (the first four steps). Past that the
  live-BN steps (ill-conditioned in float32, ROADMAP note 9) compound at the
  sweep's growing rates, and JAX's own sweep on inputs rounded by 1e-6 moves
  by up to 6% at the last step: each loss is held within the larger of 1e-2
  and 4x that move (two draws) at its step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pets_face_recognition_tpu.engine.controller import Controller as JController
from pets_face_recognition_tpu.losses import SoftmaxBasedMetricLearning as JWrapper
from pets_face_recognition_tpu.models import embedder as j_embedder
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.utils import tuners as j_tuners
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.engine.controller import Controller
from pets_face_recognition_tpu_torch.losses import SoftmaxBasedMetricLearning
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
from pets_face_recognition_tpu_torch.utils import DictWrapper, tuners
from pets_face_recognition_tpu_torch.utils.optim import fe_sgd_optimizer

torch.set_num_threads(1)

STAGES, D, C, B, IMG = (1, 1, 1, 1), 64, 6, 4, 64


class _OomStub:
    """The port's controller interface; a step above ``limit`` rows runs out
    of device memory (or raises ``error``)."""

    def __init__(self, limit, error=None):
        self.limit, self.error, self.tried = limit, error, []

    def init_state(self, seed=0, device="cuda"):
        return {"seed": seed}

    def train_step(self, state, batch):
        n = len(batch["x"])
        self.tried.append(n)
        if n > self.limit:
            raise self.error or torch.cuda.OutOfMemoryError(
                f"CUDA out of memory. Tried to allocate {n} MiB")
        return {"loss": 0.0}


class _JaxOomStub:
    """JAX's twin: its step raises ``RESOURCE_EXHAUSTED`` above ``limit``."""

    def __init__(self, limit):
        self.limit, self.tried = limit, []

    def init_state(self, rng, batch):
        return {"step": jnp.asarray(0)}

    def make_train_step(self):
        def step(state, batch, rng):
            n = len(batch["x"])
            self.tried.append(n)
            if n > self.limit:
                raise RuntimeError(f"RESOURCE_EXHAUSTED: Out of memory allocating {n} bytes")
            return type("S", (), {"step": jnp.asarray(1)})(), {}
        return step


@pytest.mark.parametrize("start,max_trials,limit", [(16, 8, 100), (16, 8, 10 ** 6), (16, 8, 8),
                                                    (4, 3, 40), (2, 5, 2)])
def test_find_max_batch_size_matches_jax(start, max_trials, limit):
    sample = {"x": np.zeros((2, 3), np.float32), "label": np.arange(2)}
    port, twin = _OomStub(limit), _JaxOomStub(limit)
    got = tuners.find_max_batch_size(port, sample, start, max_trials, device="cpu")
    want = j_tuners.find_max_batch_size(twin, sample, start, max_trials)
    assert got == want and port.tried == twin.tried


@pytest.mark.parametrize("error", [ValueError("bad batch"),
                                   RuntimeError("CUDA out of memory (not an OOM error)")])
def test_find_max_batch_size_lets_other_errors_through(error):
    stub = _OomStub(20, error)
    with pytest.raises(type(error), match=str(error)[:8]):
        tuners.find_max_batch_size(stub, {"x": np.zeros((1, 3))}, device="cpu")
    assert stub.tried == [16, 32]


def _batches():
    rng = np.random.RandomState(4)
    return [{"x": rng.rand(B, IMG, IMG, 3).astype(np.float32),
             "label": rng.randint(0, C, B).astype(np.int32),
             "index": np.arange(B, dtype=np.int32) + B * i} for i in range(3)]


class _RecordingJController(JController):
    """JAX's FE controller with each sweep step's loss recorded. Every sweep
    runs one compiled step: each sweep builds its own ``inject_hyperparams``
    SGD, which reads its rate from the optimiser state, so the first sweep's
    ``tx`` computes what any other's would."""

    losses: list
    _shared: dict = {}

    def make_train_step(self):
        shared = self._shared
        if "step" not in shared:
            shared["step"] = super().make_train_step()

        def recorded(state, batch, rng):
            tx = shared.setdefault("tx", state.tx)
            state, metrics = shared["step"](state.replace(tx=tx), batch, rng)
            self.losses.append(float(metrics["loss"]))
            return state, metrics
        return recorded


def test_find_optimal_init_lr_matches_jax():
    j_model = JWrapper(model=j_embedder.EmbeddingModel(
        backbone=j_resnet.ResNet(stage_sizes=STAGES), embedding_dim=D), emb_size=D,
        num_classes=C, margin_type="arc", use_focal=True)
    config = DictWrapper({"model": lambda: None, "loss": lambda c, m: j_model,
                          "optimizer": lambda c: optax.sgd(0.1)})
    j_ctl = _RecordingJController(config)
    j_ctl.losses = []
    batches = _batches()
    want = j_tuners.find_optimal_init_lr(j_ctl, batches, min_lr=1e-5, max_lr=1.0, num_steps=12)
    # JAX against itself: the sweep on inputs changed by 1e-6 relative
    j_spread = []
    for s in (1, 2):
        twin = _RecordingJController(config)
        twin.losses = []
        rounded = [dict(b, x=(b["x"] * (1 + np.random.RandomState(s * 10 + i).randn(*b["x"].shape)
                                        * 1e-6)).astype(np.float32))
                   for i, b in enumerate(batches)]
        j_tuners.find_optimal_init_lr(twin, rounded, min_lr=1e-5, max_lr=1.0, num_steps=12)
        j_spread.append(twin.losses)
    # JAX's initial weights, as its sweep's init_state draws them
    j_state = JController(config).init_state(jax.random.PRNGKey(0), batches[0])
    sd = weights.to_tensors(weights.fe_state_dict({"params": j_state.params,
                                                   "batch_stats": j_state.batch_stats}))

    class PortController(Controller):
        """The port's FE controller on JAX's weights, each sweep step's rate
        and loss recorded."""

        def init_state(self, seed=0, device="cuda", model=None):
            wrapper = SoftmaxBasedMetricLearning(resnet50_embedder(D, stage_sizes=STAGES), D, C)
            wrapper.load_state_dict(sd, strict=True)
            return super().init_state(seed, device, model=wrapper)

        def train_step(self, state, batch):
            metrics = super().train_step(state, batch)
            history.append((state.optimizer.param_groups[0]["lr"], float(metrics["loss"])))
            return metrics

    ctl = PortController(DictWrapper({"optimizer": lambda c: fe_sgd_optimizer}),
                         gradient_clip_val=0.5, accumulate_grad_batches=2)
    history = []
    got = tuners.find_optimal_init_lr(ctl, batches, min_lr=1e-5, max_lr=1.0, num_steps=12,
                                      device="cpu")
    assert (ctl.gradient_clip_val, ctl.accumulate_grad_batches) == (0.5, 2)
    lrs = np.exp(np.linspace(np.log(1e-5), 0.0, 12))
    assert len(history) == len(j_ctl.losses[: len(history)]) > 0
    assert [lr for lr, _ in history] == pytest.approx(lrs[: len(history)].tolist(), rel=1e-12)
    for i, ((lr, loss), want_loss) in enumerate(zip(history, j_ctl.losses)):
        err = abs(loss - want_loss) / abs(want_loss)
        spread = max(abs(x[i] - want_loss) / abs(want_loss) for x in j_spread)
        bound = 1e-4 if lr < 3e-4 else max(1e-2, 4 * spread)
        assert err <= bound, (i, lr, loss, want_loss, spread)
    finite = [x for x in j_ctl.losses if np.isfinite(x)]
    assert len(history) == len(finite)
    assert got == pytest.approx(want, rel=1e-12)
