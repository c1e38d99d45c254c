"""Train state (counterpart of the JAX ``engine/train_state.py``): the model,
its optimiser and schedule, the step counter and the sampler's generator, as
one plain object. PyTorch updates the model and the optimiser in place, so the
step mutates this state instead of returning a new one."""

from __future__ import annotations

import dataclasses

import torch

from ..utils.optim import Schedule


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    generator: torch.Generator
    step: int = 0
