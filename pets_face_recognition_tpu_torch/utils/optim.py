"""Optimisers of the port (counterpart of the JAX ``utils/optim.py``).

``detection_sgd_optimizer`` is ``torch.optim.SGD`` with momentum and weight
decay over every trainable parameter, which equals the JAX package's
``optax.chain(add_decayed_weights(wd), sgd(schedule, momentum))`` step for
step: both add ``wd * p`` to the gradient, keep ``t = g + momentum * t``, and
step ``p -= lr * t``. The learning rate follows ``multistep_schedule`` and is
set on the optimiser before each step by :func:`set_learning_rate`.

Gradient accumulation over ``k`` batches is ``optax.MultiSteps(every_k_schedule
=k)`` around that chain (the JAX ``wrap_gradient_transform``): each mini-step's
gradient joins a running mean (:func:`accumulate_mean_`); on every ``k``-th
the mean is clipped and stepped once, at the rate of the schedule's count of
such updates, and the mean restarts from zero.

The feature extractor's recipes: ``fe_sgd_optimizer``, the JAX
``optax.multi_transform`` over ``_label_fn``'s three groups as three
``torch.optim.SGD`` parameter groups, each scaled from the one schedule by its
``lr_scale`` (backbone 1/2, ``fc`` 1, margin head 1 with weight decay 1e-4
added before momentum), and ``fe_adamw_optimizer``, ``optax.adamw`` as
``torch.optim.AdamW`` (eps 1e-8; the decoupled decay scaled by the scheduled
rate, as optax scales its whole update).
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import torch

Schedule = Callable[[int], float]


def multistep_schedule(base_lr: float, milestones_steps: Sequence[int],
                       gamma: float = 0.1) -> Schedule:
    """``optax.piecewise_constant_schedule``: the rate at step ``count`` is
    ``base_lr * gamma ** (number of milestones <= count)``."""
    milestones = sorted(int(m) for m in milestones_steps)

    def schedule(count: int) -> float:
        lr = base_lr
        for m in milestones:
            if count >= m:
                lr *= gamma
        return lr

    return schedule


def detection_sgd_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 5e-3,
                            momentum: float = 0.9, weight_decay: float = 1e-4,
                            milestones_steps: Sequence[int] = (), gamma: float = 0.1,
                            ) -> tuple[torch.optim.SGD, Schedule]:
    """SGD with momentum and weight decay over ``params``, and its schedule."""
    opt = torch.optim.SGD(list(params), lr=lr, momentum=momentum,
                          weight_decay=weight_decay)
    return opt, multistep_schedule(lr, milestones_steps, gamma)


def fe_param_group(name: str) -> str:
    """The JAX ``_label_fn``: ``margin`` for the head ``add_margin``, ``fc``
    for the embedder's projection, ``backbone`` for the rest (BN affine
    included)."""
    parts = name.split(".")
    if "add_margin" in parts:
        return "margin"
    if "fc" in parts and "backbone" not in parts:
        return "fc"
    return "backbone"


def fe_sgd_optimizer(model: torch.nn.Module, lr: float = 1e-2, momentum: float = 0.9,
                     margin_weight_decay: float = 1e-4, milestones_steps: Sequence[int] = (),
                     gamma: float = 0.1) -> tuple[torch.optim.SGD, Schedule]:
    """The reference FE SGD over ``model``'s named parameters: backbone at
    lr/2, ``fc`` at lr, the margin head at lr with weight decay; momentum 0.9
    for all. Returns the optimiser and the schedule of ``lr``."""
    groups = {"backbone": [], "fc": [], "margin": []}
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups[fe_param_group(name)].append(p)
    scale = {"backbone": 0.5, "fc": 1.0, "margin": 1.0}
    opt = torch.optim.SGD(
        [{"params": ps, "lr": lr * scale[g], "lr_scale": scale[g],
          "weight_decay": margin_weight_decay if g == "margin" else 0.0}
         for g, ps in groups.items() if ps], lr=lr, momentum=momentum)
    return opt, multistep_schedule(lr, milestones_steps, gamma)


def fe_adamw_optimizer(model: torch.nn.Module, lr: float = 1e-4, weight_decay: float = 1e-4,
                       milestones_steps: Sequence[int] = (), gamma: float = 0.1,
                       ) -> tuple[torch.optim.AdamW, Schedule]:
    """``optax.adamw(schedule, weight_decay)`` over every trainable parameter
    of ``model``: betas (0.9, 0.999), eps 1e-8."""
    opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], lr=lr,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    return opt, multistep_schedule(lr, milestones_steps, gamma)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Each group's rate: ``lr`` times its ``lr_scale`` (1 when absent)."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("lr_scale", 1.0)


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.nn.Parameter], max_norm: float,
                         ) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place on the gradients: unchanged when
    their global norm is below ``max_norm``, else scaled by ``max_norm / norm``.
    Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


@torch.no_grad()
def accumulate_mean_(accum: list[torch.Tensor], grads: list[torch.Tensor],
                     mini_step: int) -> None:
    """``optax.MultiSteps``' Welford mean in place: ``acc += (g - acc) /
    (mini_step + 1)`` for the ``mini_step``-th gradient (from 0)."""
    for a, g in zip(accum, grads):
        a.add_((g - a) / (mini_step + 1))

