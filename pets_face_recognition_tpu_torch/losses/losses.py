"""Classification and detection losses (counterpart of the JAX
``losses/losses.py`` and of ``losses/__init__.py::SumDetectionLoss``):
weighted softmax cross entropy, the focal loss of the feature extractor, the
numerically stable sigmoid BCE and smooth-L1 with torchvision's beta = 1/9.
Every function returns float32 and takes the JAX package's layouts."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross entropy over the rows; ``weights`` masks or reweights
    rows (sum of weighted NLL over ``max(sum(weights), 1e-8)``)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    if weights is not None:
        return (nll * weights).sum() / weights.sum().clamp(min=1e-8)
    return nll.mean()


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 0.0,
               alpha: torch.Tensor | None = None,
               weights: torch.Tensor | None = None) -> torch.Tensor:
    """``(1 - p_t)^gamma * (-log p_t)`` averaged over the rows. ``alpha`` (C,)
    scales the logits before the softmax (a per-class temperature, as the
    reference's ``FocalLoss`` does); ``weights`` averages the rows with those
    weights. The production configs keep ``gamma`` 0: plain cross entropy."""
    logits = logits.float()
    if alpha is not None:
        logits = logits * alpha[None, :]
    logp_t = torch.gather(F.log_softmax(logits, dim=-1), -1, labels.long()[:, None])[:, 0]
    loss = -((1.0 - torch.exp(logp_t)) ** gamma) * logp_t
    if weights is not None:
        return (loss * weights).sum() / weights.sum().clamp(min=1e-8)
    return loss.mean()


def optax_sigmoid_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Element-wise sigmoid BCE, ``max(x, 0) - x t + log1p(exp(-|x|))``."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0 / 9.0) -> torch.Tensor:
    """Element-wise smooth-L1 (Huber), the RPN and box-head regression loss."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)


def sum_detection_loss(losses: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``SumDetectionLoss`` in training: ``{'loss': sum of the terms, **terms}``."""
    return {"loss": sum(losses.values()), **losses}
