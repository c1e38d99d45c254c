"""Training runtime (counterpart of the JAX ``engine/trainer.py``): the
epoch loop of the reference's Lightning-style trainer.

- epochs of the controller's ``train_step`` over its train loader, with
  validation after each epoch and, with ``val_check_interval`` (a fraction
  of the epoch or a number of batches), inside it;
- ``fast_dev_run``, ``limit_train_batches``, ``limit_val_batches`` and
  ``overfit_batches`` (the first N train batches every epoch, no validation);
- ``gradient_clip_val`` and ``accumulate_grad_batches``, handed to the
  controller before its state is built;
- a checkpoint after every epoch as ``checkpoints/epoch=N-step=M`` and resume
  from ``resume_from_checkpoint`` or the newest checkpoint there, at epoch
  ``N + 1``. The loader is made anew, so a resumed run shuffles its first
  epoch as a fresh run shuffles epoch 0 (a JAX-package quirk, kept);
- a stop on non-finite loss, checked at the logging cadence;
- SIGINT/SIGTERM: finish the step, validate, checkpoint and stop;
- per epoch ``epoch_loss``, ``epoch_time_s``, ``data_time_s`` (waiting for
  the loader) and ``step_time_s`` to the logger, and the logger's
  ``finalize`` with the run's status;
- ``profiler=<dir>``: a ``torch.profiler`` trace of the first epoch run,
  written to ``<dir>/trace.json``.

``fit`` runs in float32 (TF32 off inside, the caller's flags back after).
"""

from __future__ import annotations

import contextlib
import signal
import time
from pathlib import Path

import numpy as np
import torch

from ..device import float32_matmuls
from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .logging import MetricsLogger
from .train_state import TrainState


def _as_list(dl):
    return dl if isinstance(dl, (list, tuple)) else [dl]


class Trainer:
    def __init__(
        self,
        config=None,
        logger: MetricsLogger | None = None,
        max_epochs: int | None = None,
        enable_checkpointing: bool = True,
        default_root_dir: str | Path = ".",
        val_check_interval: float | int = 1.0,
        limit_train_batches: int | None = None,
        limit_val_batches: int | None = None,
        log_every_n_steps: int = 50,
        fast_dev_run: bool = False,
        overfit_batches: int | float = 0,
        gradient_clip_val: float | None = None,
        accumulate_grad_batches: int = 1,
        resume_from_checkpoint: str | Path | None = None,
        profiler: str | Path | None = None,
        terminate_on_nan: bool = True,
        device: str | torch.device = "cuda",
    ):
        self.config = config
        self.logger = logger
        self.max_epochs = max_epochs or (config.n_epochs if config else 1)
        self.enable_checkpointing = enable_checkpointing
        self.default_root_dir = Path(default_root_dir)
        self.val_check_interval = val_check_interval
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.log_every_n_steps = log_every_n_steps
        self.fast_dev_run = fast_dev_run
        # an int is a number of batches, a float in (0, 1) a share of the loader
        self.overfit_batches = overfit_batches
        self.gradient_clip_val = gradient_clip_val
        self.accumulate_grad_batches = int(accumulate_grad_batches)
        self.resume_from_checkpoint = resume_from_checkpoint
        self.profiler_dir = Path(profiler) if profiler else None
        self.terminate_on_nan = terminate_on_nan
        self.device = device
        if fast_dev_run:
            self.max_epochs = 1
            self.limit_train_batches = 1
            self.limit_val_batches = 1
        self._stop_requested = False
        self.state: TrainState | None = None
        self.current_epoch = 0
        self.start_epoch = 0

    # -- signal handling ----------------------------------------------------
    @contextlib.contextmanager
    def _signal_handlers(self):
        """SIGINT and SIGTERM ask for a stop after the current step; the
        previous handlers come back on exit."""
        def handler(signum, frame):
            print(f"[trainer] signal {signum}: will stop after current step", flush=True)
            self._stop_requested = True

        saved = {}
        try:
            for sig in (signal.SIGINT, signal.SIGTERM):
                saved[sig] = signal.signal(sig, handler)
        except ValueError:  # not the main thread: no handlers
            pass
        try:
            yield
        finally:
            for sig, old in saved.items():
                signal.signal(sig, old)

    # -- fit ------------------------------------------------------------------
    @float32_matmuls()
    def fit(self, controller, state: TrainState | None = None) -> TrainState:
        status = "FINISHED"
        try:
            with self._signal_handlers():
                self._fit_inner(controller, state)
        except BaseException:
            status = "FAILED"
            raise
        finally:
            if self.logger is not None:
                self.logger.finalize(status)
        return self.state

    def _fit_inner(self, controller, state):
        config = self.config or controller.config
        controller.gradient_clip_val = self.gradient_clip_val
        controller.accumulate_grad_batches = self.accumulate_grad_batches

        train_loader = controller.train_dataloader()
        if self.overfit_batches:
            n = self.overfit_batches
            if isinstance(n, float) and 0 < n < 1:
                n = max(1, int(len(train_loader) * n))
            n = int(n)
            fixed = []
            for i, b in enumerate(train_loader):
                if i >= n:
                    break
                fixed.append(b)
            train_loader = fixed
            print(f"[trainer] overfit_batches={self.overfit_batches} -> {n} "
                  "fixed batches every epoch; validation skipped")
        # the JAX trainer reads a first batch to build its state; reading it
        # here too keeps the loader's epoch count, so epoch e shuffles alike
        next(iter(train_loader))

        if state is None:
            state = controller.init_state(int(config.get("seed", 0)), self.device)
        ckpt_dir = self.default_root_dir / "checkpoints"
        start_epoch = 0
        if self.resume_from_checkpoint or (
            self.enable_checkpointing and latest_checkpoint(ckpt_dir)
        ):
            path = self.resume_from_checkpoint or latest_checkpoint(ckpt_dir)
            start_epoch = restore_checkpoint(state, path) + 1
            print(f"[trainer] resumed from {path} (epoch {start_epoch})", flush=True)
        self.start_epoch = start_epoch

        n_batches = _count_batches(train_loader, self.limit_train_batches)
        val_every = (0 if self.overfit_batches
                     else self._val_interval_steps(n_batches))

        for epoch in range(start_epoch, self.max_epochs):
            self.current_epoch = epoch
            epoch_start = time.time()
            losses = []
            profiler = None
            if self.profiler_dir is not None and epoch == start_epoch:
                profiler = _profile(state)
                profiler.start()
            data_time = step_time = 0.0
            t_mark = time.time()
            for batch_idx, batch in enumerate(train_loader):
                if self.limit_train_batches and batch_idx >= self.limit_train_batches:
                    break
                data_time += time.time() - t_mark
                t_mark = time.time()
                with torch.profiler.record_function(f"train_step {state.step}"):
                    metrics = controller.train_step(state, batch)
                step_time += time.time() - t_mark
                t_mark = time.time()
                losses.append(metrics["loss"])
                logging_step = (batch_idx + 1) % self.log_every_n_steps == 0
                if (self.terminate_on_nan and logging_step
                        and not np.isfinite(metrics["loss"])):
                    print(f"[trainer] non-finite loss at step {state.step}"
                          " - stopping (terminate_on_nan)", flush=True)
                    self._stop_requested = True
                    break
                if logging_step and self.logger:
                    self.logger.log_metrics(metrics, state.step)
                if val_every and (batch_idx + 1) % val_every == 0 and (
                    batch_idx + 1
                ) < n_batches:
                    self.validate(controller, state, epoch)
                if self._stop_requested:
                    break

            if profiler is not None:
                profiler.stop()
                self.profiler_dir.mkdir(parents=True, exist_ok=True)
                profiler.export_chrome_trace(str(self.profiler_dir / "trace.json"))
                print(f"[trainer] profile written to {self.profiler_dir}", flush=True)
            mean_loss = float(np.mean(losses)) if losses else 0.0
            if self.logger:
                self.logger.log_metrics(
                    {"epoch_loss": mean_loss,
                     "epoch_time_s": time.time() - epoch_start,
                     "data_time_s": data_time,
                     "step_time_s": step_time},
                    state.step,
                )
            if not self.overfit_batches:
                self.validate(controller, state, epoch)
            if self.enable_checkpointing:
                path = save_checkpoint(ckpt_dir, state, epoch)
                print(f"[trainer] checkpoint: {path}", flush=True)
            if self._stop_requested:
                print("[trainer] graceful stop", flush=True)
                break
        self.state = state
        return state

    def _val_interval_steps(self, n_batches: int | None):
        v = self.val_check_interval
        if not v or v == 1.0 or n_batches is None:
            return None
        if isinstance(v, float):
            return max(int(n_batches * v), 1)
        return int(v)

    # -- validation / test ------------------------------------------------
    def validate(self, controller, state: TrainState | None = None,
                 epoch: int | None = None):
        state = state if state is not None else self.state
        return self._run_eval(
            controller, state, _as_list(controller.val_dataloader()),
            epoch if epoch is not None else self.current_epoch, prefix="val "
        )

    def test(self, controller, state: TrainState | None = None):
        state = state if state is not None else self.state
        return self._run_eval(
            controller, state, _as_list(controller.test_dataloader()),
            self.current_epoch, prefix="test ",
        )

    def predict(self, controller, state: TrainState | None = None) -> list[dict]:
        """Each test batch's ``run_eval_batch`` output, on the host."""
        state = state if state is not None else self.state
        eval_step = controller.make_eval_step()
        outputs = []
        for loader in _as_list(controller.test_dataloader()):
            for batch_idx, batch in enumerate(loader):
                if self.limit_val_batches and batch_idx >= self.limit_val_batches:
                    break
                outputs.append(controller.run_eval_batch(eval_step, state, batch))
        return outputs

    def _run_eval(self, controller, state, loaders, epoch, prefix):
        eval_step = controller.make_eval_step()
        outputs = []
        for loader in loaders:
            batches = []
            for batch_idx, batch in enumerate(loader):
                if self.limit_val_batches and batch_idx >= self.limit_val_batches:
                    break
                batches.append(controller.run_eval_batch(eval_step, state, batch))
            outputs.append(batches)
        return controller.evaluate(outputs, logger=self.logger, epoch=epoch,
                                   prefix=prefix)


def _profile(state: TrainState) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if next(state.model.parameters()).is_cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _count_batches(loader, limit) -> int | None:
    try:
        n = len(loader)
    except TypeError:
        return None
    return min(n, limit) if limit else n


def configure_trainer(config, logger=None, **overrides) -> Trainer:
    """A Trainer from a config: its ``n_epochs``, ``output``,
    ``val_check_interval``, ``enable_checkpointing`` and the known keys of its
    ``trainer_kwargs``; ``overrides`` last."""
    kwargs = dict(
        config=config,
        logger=logger,
        max_epochs=config.get("n_epochs", 1),
        default_root_dir=config.get("output", "."),
        val_check_interval=config.get("val_check_interval", 1.0),
        enable_checkpointing=config.get("enable_checkpointing", True),
    )
    extra = dict(config.get("trainer_kwargs", {}) or {})
    known = {"limit_train_batches", "limit_val_batches", "log_every_n_steps",
             "fast_dev_run", "resume_from_checkpoint", "profiler",
             "val_check_interval", "enable_checkpointing", "max_epochs",
             "overfit_batches", "gradient_clip_val",
             "accumulate_grad_batches", "terminate_on_nan"}
    kwargs.update({k: v for k, v in extra.items() if k in known})
    kwargs.update(overrides)
    return Trainer(**kwargs)
