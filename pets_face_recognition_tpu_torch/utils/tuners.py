"""Batch-size and learning-rate tuners (counterpart of the JAX
``utils/tuners.py``), over the port's controller interface
(``init_state(seed, device)``, ``train_step(state, batch)``).

- :func:`find_max_batch_size`: double the batch from ``start`` until a
  training step runs out of device memory; return the last batch that ran.
  Only ``torch.cuda.OutOfMemoryError`` ends the search (JAX catches only
  ``RESOURCE_EXHAUSTED``); every other error propagates. After each trial
  its state is dropped and the allocator's cache emptied.
- :func:`find_optimal_init_lr`: the LR range test. The rate sweeps
  exponentially from ``min_lr`` to ``max_lr`` over ``num_steps`` steps of
  momentum-0.9 SGD (no weight decay, no clipping), stopping at the first
  non-finite loss; the losses are smoothed by a 5-tap mean (``mode="same"``)
  and the rate at the smoothed minimum, divided by 10, is returned.
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from ..device import resolve_device


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def find_max_batch_size(controller, sample_batch: dict, start: int = 16, max_trials: int = 8,
                        device: str | torch.device = "cuda") -> int:
    """The largest of ``start, 2 start, ...`` (``max_trials`` of them) whose
    step on the first row of ``sample_batch`` repeated fits; 0 if none."""
    dev = resolve_device(device)

    def try_batch(bs: int) -> bool:
        batch = {k: np.repeat(np.asarray(v)[:1], bs, axis=0) for k, v in sample_batch.items()}
        try:
            state = controller.init_state(0, dev)
            controller.train_step(state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return True
        except torch.cuda.OutOfMemoryError:
            return False

    bs, best = start, 0
    for _ in range(max_trials):
        fits = try_batch(bs)
        _free(dev)
        if not fits:
            break
        best = bs
        bs *= 2
    return best


def find_optimal_init_lr(controller, loader, min_lr: float = 1e-6, max_lr: float = 1.0,
                         num_steps: int = 100, device: str | torch.device = "cuda") -> float:
    """The LR range test over ``loader`` (cycled)."""
    dev = resolve_device(device)
    lrs = np.exp(np.linspace(math.log(min_lr), math.log(max_lr), num_steps))
    it = iter(loader)
    batch = next(it)
    state = controller.init_state(0, dev)
    params = [p for p in state.model.parameters() if p.requires_grad]
    state.optimizer = torch.optim.SGD(params, lr=float(lrs[0]), momentum=0.9)
    current = {"lr": float(lrs[0])}
    state.schedule = lambda _count: current["lr"]
    # the sweep's optimiser replaces the task's, its clipping and accumulation too
    saved = controller.gradient_clip_val, controller.accumulate_grad_batches
    controller.gradient_clip_val, controller.accumulate_grad_batches = None, 1
    losses = []
    try:
        for lr in lrs:
            current["lr"] = float(lr)
            loss = float(controller.train_step(state, batch)["loss"])
            if not math.isfinite(loss):
                break
            losses.append((float(lr), loss))
            try:
                batch = next(it)
            except StopIteration:
                it = iter(loader)
                batch = next(it)
    finally:
        controller.gradient_clip_val, controller.accumulate_grad_batches = saved
    if not losses:
        return min_lr
    smooth = np.convolve(np.array([l for _, l in losses]), np.ones(5) / 5, mode="same")
    return float(losses[int(np.argmin(smooth))][0] / 10.0)
