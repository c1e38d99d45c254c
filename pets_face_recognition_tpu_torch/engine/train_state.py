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

from ..utils.optim import Schedule


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
