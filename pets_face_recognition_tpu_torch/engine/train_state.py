"""Train state (counterpart of the JAX ``engine/train_state.py``): the model,
its optimiser and schedule, the sampler seed, the step counter and the
partial gradient average of an unfinished accumulation, as one plain object.
PyTorch updates the model and the optimiser in place, so the step mutates
this state instead of returning a new one.

The sampler noise of a step is drawn from :func:`step_generator` of the seed
and the step, as the JAX trainer draws ``fold_in(key, step)``: a run resumed
at step ``s`` draws what the uninterrupted run draws there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.optim import (Schedule, accumulate_mean_, clip_by_global_norm_,
                           set_learning_rate)


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from ``(seed, step)`` alone."""
    mixed = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    seed: int = 0
    step: int = 0
    # the running mean of this accumulation's gradients, a tensor a trainable
    # parameter (``optax.MultiSteps``' ``acc_grads``); None outside one
    accum: list[torch.Tensor] | None = None


def finish_step(state: TrainState, accumulate_grad_batches: int = 1,
                gradient_clip_val: float | None = None) -> bool:
    """After a mini-step's ``backward()``: count it, and update unless an
    accumulation is unfinished (``optax.MultiSteps``). With ``k > 1`` each
    mini-step's gradient joins the running mean, and every ``k``-th the mean is
    stepped; the update clips if asked and steps the optimiser at the
    scheduled rate of its count of updates, not of mini-steps. Returns whether
    it updated."""
    every = accumulate_grad_batches
    mini_step = state.step % every
    state.step += 1
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    if every > 1:
        if state.accum is None:
            state.accum = [torch.zeros_like(p) for p in params]
        accumulate_mean_(state.accum, [p.grad for p in params], mini_step)
        if mini_step + 1 < every:
            return False
        for p, a in zip(params, state.accum):
            p.grad = a
        state.accum = None
    if gradient_clip_val:
        clip_by_global_norm_(params, gradient_clip_val)
    set_learning_rate(state.optimizer, state.schedule((state.step - 1) // every))
    state.optimizer.step()
    return True
