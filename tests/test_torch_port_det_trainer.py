"""The port's epoch trainer on the CPU: checkpoints named as the JAX trainer
names them, ``metrics.jsonl`` written as the JAX trainer writes it (its
validation keys checked against the JAX ``evaluate`` and ``MetricsLogger`` on
the same outputs), resume that restores the parameters, momentum, step and
epoch bit-equal and continues as the uninterrupted run, the graceful stop on
SIGTERM, the NaN guard, and the smoke knobs (``fast_dev_run``,
``val_check_interval``, ``overfit_batches``, ``limit_*_batches``).

A cut-down keypoint R-CNN (trunk stages (1, 1, 1, 1) at production widths,
B = 2 at 64 x 64, RPN 32 / 16 in training and 64 / 16 in eval, 4 box samples
an image) over two fixed batches an epoch; a one-parameter probe model where
only the trainer's control flow is checked.
"""

import json
import os
import signal
import types
from functools import partial

import numpy as np
import pytest
import torch
from torch import nn

from pets_face_recognition_tpu.engine.detector_controller import \
    KeyPointsController as JKeyPointsController
from pets_face_recognition_tpu.engine.logging import MetricsLogger as JMetricsLogger
from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
from pets_face_recognition_tpu_torch.engine.checkpoint import (latest_checkpoint,
                                                               restore_checkpoint)
from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
from pets_face_recognition_tpu_torch.engine.logging import MetricsLogger
from pets_face_recognition_tpu_torch.engine.trainer import Trainer, configure_trainer
from pets_face_recognition_tpu_torch.models.rcnn import keypointrcnn_resnet50_fpn
from pets_face_recognition_tpu_torch.utils import DictWrapper
from pets_face_recognition_tpu_torch.utils.optim import detection_sgd_optimizer

torch.set_num_threads(1)

SEED = 7
LOSS_TERMS = {"loss", "loss_objectness", "loss_rpn_box_reg", "loss_classifier",
              "loss_box_reg", "loss_keypoint"}
EPOCH_KEYS = {"epoch_loss", "epoch_time_s", "data_time_s", "step_time_s"}
TRAIN = [synthetic_keypoint_batch(2, 64, 64, 2, seed=s) for s in (1, 2)]
VAL = [synthetic_keypoint_batch(2, 64, 64, 2, seed=3)]


class Loader:
    """A loader over fixed batches (a list would read as a list of loaders)."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def tiny_detector():
    return keypointrcnn_resnet50_fpn(
        stage_sizes=(1, 1, 1, 1), rpn_pre_nms_top_n_train=32, rpn_post_nms_top_n_train=16,
        box_batch_size_per_image=4, rpn_pre_nms_top_n_test=64, rpn_post_nms_top_n_test=16)


def detector_config(**extra):
    return DictWrapper(dict(seed=SEED, n_epochs=2, model=tiny_detector,
                            optimizer=lambda c: partial(detection_sgd_optimizer, lr=1e-2),
                            train_dataloader=lambda: Loader(TRAIN),
                            val_dataloader=lambda: Loader(VAL), **extra))


def fit(root, max_epochs, **kw):
    config = detector_config()
    trainer = Trainer(config, logger=MetricsLogger(root), max_epochs=max_epochs,
                      default_root_dir=root, log_every_n_steps=1, device="cpu", **kw)
    trainer.fit(KeyPointsController(config=config))
    return trainer


def records(root):
    return [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]


def momentum(state):
    return [state.optimizer.state[p]["momentum_buffer"]
            for g in state.optimizer.param_groups for p in g["params"]]


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    return root, fit(root, 2)


def test_checkpoints_are_named_by_epoch_and_step(fitted):
    root, trainer = fitted
    names = sorted(p.name for p in (root / "checkpoints").iterdir())
    assert names == ["epoch=0-step=2", "epoch=1-step=4"]
    assert latest_checkpoint(root / "checkpoints").name == "epoch=1-step=4"
    assert trainer.state.step == 4 and trainer.current_epoch == 1


def test_metrics_jsonl_is_written_as_the_jax_trainer_writes_it(fitted, tmp_path):
    """Per epoch: a record a logged step (the loss terms), the epoch record,
    then the validation record, all stamped with the step; the validation
    record's keys are those the JAX ``evaluate`` logs through the JAX
    ``MetricsLogger`` for the same eval outputs."""
    root, trainer = fitted
    recs = records(root)
    kinds = [("step" if LOSS_TERMS <= set(r) else "epoch" if EPOCH_KEYS <= set(r)
              else "val") for r in recs]
    assert kinds == ["step", "step", "epoch", "val"] * 2
    assert [r["step"] for r in recs] == [1, 2, 2, 0, 3, 4, 4, 1]
    for r, kind in zip(recs, kinds):
        want = {"step", "time"} | {"step": LOSS_TERMS, "epoch": EPOCH_KEYS}.get(kind, set())
        if kind != "val":
            assert set(r) == want
    ctl = KeyPointsController(config=detector_config())
    outputs = [[ctl.run_eval_batch(ctl.make_eval_step(), trainer.state, b) for b in VAL]]
    fake = types.SimpleNamespace(**{k: getattr(JKeyPointsController, k) for k in
                                    ("eval_thresholds", "with_masks", "with_keypoints")})
    JKeyPointsController.evaluate(fake, outputs, logger=JMetricsLogger(tmp_path), epoch=1,
                                  prefix="val ")
    want = records(tmp_path)[0]
    assert list(recs[-1]) == list(want)
    assert {k: v for k, v in recs[-1].items() if k != "time"} == pytest.approx(
        {k: v for k, v in want.items() if k != "time"}, nan_ok=True)


def test_resume_restores_the_state_bit_equal(fitted):
    """The newest checkpoint loaded into a fresh state: every parameter and
    buffer, every momentum buffer and the step equal the fitted state's, and
    the epoch is the last one run."""
    root, trainer = fitted
    fresh = KeyPointsController(config=detector_config()).init_state(0, "cpu")
    epoch = restore_checkpoint(fresh, latest_checkpoint(root / "checkpoints"))
    assert epoch == 1 and fresh.step == 4 and fresh.accum is None
    want = trainer.state.model.state_dict()
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for a, b in zip(momentum(fresh), momentum(trainer.state), strict=True):
        assert torch.equal(a, b)


def test_resumed_run_continues_as_the_uninterrupted_one(fitted, tmp_path):
    """One epoch, then a new trainer with two epochs resumes at epoch 1 and
    step 2 and runs the same steps (the sampler noise depends on the seed and
    the step only): its parameters and momentum end bit-equal to the
    uninterrupted two-epoch run's."""
    _, trainer = fitted
    first = fit(tmp_path, 1)
    assert first.state.step == 2
    second = fit(tmp_path, 2)
    assert second.start_epoch == 1 and second.state.step == 4
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
        "epoch=0-step=2", "epoch=1-step=4"]
    want = trainer.state.model.state_dict()
    for k, v in second.state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for a, b in zip(momentum(second.state), momentum(trainer.state), strict=True):
        assert torch.equal(a, b)


class Probe(nn.Module):
    """One parameter; a finite loss unless ``nan_at`` names the call; eval
    returns one invalid detection an image."""

    def __init__(self, nan_at=None):
        super().__init__()
        self.w = nn.Parameter(torch.ones(()))
        self.calls = 0
        self.nan_at = nan_at

    def forward(self, images, targets=None, **_):
        B = images.shape[0]
        if targets is None:
            return {"boxes": torch.zeros(B, 1, 4), "labels": torch.ones(B, 1, dtype=torch.int64),
                    "scores": torch.zeros(B, 1), "valid": torch.zeros(B, 1, dtype=torch.bool),
                    "keypoints": torch.zeros(B, 1, 3, 3)}
        self.calls += 1
        loss = (self.w * images.mean()) ** 2
        return {"loss_a": loss * float("nan") if self.calls == self.nan_at else loss}


class Batches:
    """``n`` probe batches an epoch; ``on_batch(epoch, i)`` runs before each."""

    def __init__(self, n, on_batch=None):
        self.n, self.on_batch, self.epoch = n, on_batch, -1
        self.batch = {"images": np.ones((1, 4, 4, 3), np.float32),
                      "boxes": np.zeros((1, 1, 4)), "labels": np.zeros((1, 1)),
                      "valid": np.ones((1, 1), bool)}

    def __len__(self):
        return self.n

    def __iter__(self):
        self.epoch += 1
        for i in range(self.n):
            if self.on_batch:
                self.on_batch(self.epoch, i)
            yield self.batch


def probe_run(root, model, train, n_val=1, **kw):
    val = Batches(n_val)
    config = DictWrapper(dict(seed=0, n_epochs=3, model=lambda: model,
                              optimizer=lambda c: partial(detection_sgd_optimizer, lr=1e-3),
                              train_dataloader=lambda: train, val_dataloader=lambda: val))
    ctl = KeyPointsController(config=config)
    evals = []
    run_eval_batch = ctl.run_eval_batch
    ctl.run_eval_batch = lambda *a: evals.append(1) or run_eval_batch(*a)
    trainer = configure_trainer(config, MetricsLogger(root), default_root_dir=root,
                                device="cpu", log_every_n_steps=1, **kw)
    trainer.fit(ctl)
    ckpts = sorted(p.name for p in (root / "checkpoints").iterdir()) \
        if (root / "checkpoints").exists() else []
    return trainer, len(evals), ckpts


def test_sigterm_stops_after_the_step_and_checkpoints(tmp_path):
    """SIGTERM during epoch 0 of 3: the step in flight finishes, the epoch
    validates and checkpoints, and the run stops; the trainer's handler is
    replaced by the caller's again afterwards."""
    seen = []
    previous = signal.signal(signal.SIGTERM, lambda *a: seen.append(a))
    try:
        def on_batch(epoch, i):
            # the loader's epoch 0 is the trainer's read of a first batch
            if (epoch, i) == (1, 1):
                os.kill(os.getpid(), signal.SIGTERM)

        model = Probe()
        trainer, evals, ckpts = probe_run(tmp_path, model, Batches(3, on_batch))
        assert not seen, "the trainer did not handle SIGTERM"
        assert trainer.state.step == 2 and model.calls == 2
        assert ckpts == ["epoch=0-step=2"] and evals == 1
        assert signal.getsignal(signal.SIGTERM) is not None
        os.kill(os.getpid(), signal.SIGTERM)
        assert len(seen) == 1
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_non_finite_loss_stops_the_run(tmp_path):
    """A NaN loss at step 2 (the logging cadence is every step): the epoch
    ends there, validates and checkpoints, and no later epoch runs."""
    model = Probe(nan_at=2)
    trainer, evals, ckpts = probe_run(tmp_path, model, Batches(3))
    assert trainer.state.step == 2 and model.calls == 2
    assert ckpts == ["epoch=0-step=2"] and evals == 1
    assert not any("loss" in r and r["step"] > 2 for r in records(tmp_path))


@pytest.mark.parametrize("knobs,steps,evals,ckpts", [
    (dict(fast_dev_run=True), 1, 1, ["epoch=0-step=1"]),
    (dict(val_check_interval=0.5), 12, 6, ["epoch=0-step=4", "epoch=1-step=8",
                                           "epoch=2-step=12"]),
    (dict(overfit_batches=2, enable_checkpointing=False), 6, 0, []),
    (dict(limit_train_batches=1, limit_val_batches=1, max_epochs=2), 2, 2,
     ["epoch=0-step=1", "epoch=1-step=2"]),
    (dict(accumulate_grad_batches=2, gradient_clip_val=0.1, max_epochs=1), 4, 1,
     ["epoch=0-step=4"]),
], ids=["fast_dev_run", "val_check_interval", "overfit_batches", "limit_batches",
        "accumulate_and_clip"])
def test_trainer_knobs(tmp_path, knobs, steps, evals, ckpts):
    """The steps run, the eval batches read (2 a validation) and the
    checkpoints written under each smoke knob, 3 epochs of 4 batches
    otherwise; the clip and accumulation reach the controller."""
    model = Probe()
    trainer, n_evals, names = probe_run(tmp_path, model, Batches(4), n_val=2, **knobs)
    assert trainer.state.step == steps and n_evals == evals * (1 if "fast_dev_run" in knobs
                                                               or "limit_val_batches" in knobs
                                                               else 2)
    assert names == ckpts
    if "accumulate_grad_batches" in knobs:
        assert trainer.state.accum is None and model.w.grad.abs() <= 0.1 + 1e-7
