"""Large-margin softmax heads, ArcFace and CosFace (counterpart of the JAX
``losses/large_margin.py``).

Each head holds one ``(num_classes, in_features)`` weight, xavier-uniform.
``forward(features)`` returns ``s * cos θ`` between the l2-normalised
features and class weights; ``forward(features, labels)`` replaces the
label's column with the margin logit ``phi`` before the scale:

- ``ArcMarginProduct``: ``phi = cos(θ + m)``; with ``easy_margin`` kept only
  where ``cos θ > 0``, else kept where ``cos θ > cos(π - m)`` and
  ``cos θ - m sin(m)`` elsewhere (the monotonic fallback);
- ``AddMarginProduct``: ``phi = cos θ - m``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def cosine_logits(features: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """cos θ between l2-normalised features (B, D) and class weights (C, D)."""
    f = features / features.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    w = weight / weight.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return f @ w.T


class MarginHead(nn.Module):
    def __init__(self, in_features: int, out_features: int, s: float, m: float):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.s, self.m = s, m
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        nn.init.xavier_uniform_(self.weight)

    def phi(self, cosine: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, features: torch.Tensor, labels: torch.Tensor | None = None
                ) -> torch.Tensor:
        cosine = cosine_logits(features.to(self.weight.dtype), self.weight)
        if labels is None:
            return cosine * self.s
        one_hot = torch.zeros_like(cosine)
        one_hot[torch.arange(cosine.shape[0], device=cosine.device), labels.long()] = 1.0
        return (one_hot * self.phi(cosine) + (1.0 - one_hot) * cosine) * self.s


class ArcMarginProduct(MarginHead):
    """ArcFace: additive angular margin."""

    def __init__(self, in_features: int, out_features: int, s: float = 30.0,
                 m: float = 0.50, easy_margin: bool = False):
        super().__init__(in_features, out_features, s, m)
        self.easy_margin = easy_margin

    def phi(self, cosine: torch.Tensor) -> torch.Tensor:
        sine = torch.sqrt(torch.clamp(1.0 - cosine ** 2, 0.0, 1.0))
        phi = cosine * math.cos(self.m) - sine * math.sin(self.m)   # cos(θ + m)
        if self.easy_margin:
            return torch.where(cosine > 0, phi, cosine)
        th = math.cos(math.pi - self.m)
        mm = math.sin(math.pi - self.m) * self.m
        return torch.where(cosine > th, phi, cosine - mm)


class AddMarginProduct(MarginHead):
    """CosFace: additive cosine margin."""

    def __init__(self, in_features: int, out_features: int, s: float = 30.0,
                 m: float = 0.40):
        super().__init__(in_features, out_features, s, m)

    def phi(self, cosine: torch.Tensor) -> torch.Tensor:
        return cosine - self.m
