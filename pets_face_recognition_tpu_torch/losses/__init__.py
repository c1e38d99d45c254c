"""Losses of the port (counterpart of the JAX ``losses/``): the detection
losses, the large-margin heads and ``SoftmaxBasedMetricLearning``, the
feature extractor's training wrapper."""

from __future__ import annotations

from typing import Literal

import torch
from torch import nn

from .large_margin import AddMarginProduct, ArcMarginProduct, cosine_logits
from .losses import cross_entropy, focal_loss, optax_sigmoid_ce, smooth_l1, sum_detection_loss

__all__ = ["AddMarginProduct", "ArcMarginProduct", "SoftmaxBasedMetricLearning",
           "cosine_logits", "cross_entropy", "focal_loss", "optax_sigmoid_ce", "smooth_l1",
           "sum_detection_loss"]


class SoftmaxBasedMetricLearning(nn.Module):
    """An embedder and a large-margin head named ``add_margin`` (ArcFace for
    ``margin_type="arc"``, CosFace for ``"add"``), s 64 and m 0.5 by default.

    ``forward(x)`` returns the embeddings; ``forward(x, labels)`` returns
    ``{"loss", "emb", "logits"}``, the loss focal (gamma 0 in production:
    cross entropy) or cross entropy, ``weights`` averaging the rows. The
    embedder's norms follow its mode: ``train()`` normalises with batch
    statistics and moves the running ones, as the JAX step's
    ``mutable=["batch_stats"]``."""

    def __init__(self, model: nn.Module, emb_size: int = 512, num_classes: int = 1000,
                 margin_type: Literal["arc", "add"] = "arc", s: float = 64.0, m: float = 0.5,
                 easy_margin: bool = False, use_focal: bool = True, focal_gamma: float = 0.0):
        super().__init__()
        self.model = model
        if margin_type == "arc":
            self.add_margin = ArcMarginProduct(emb_size, num_classes, s=s, m=m,
                                               easy_margin=easy_margin)
        elif margin_type == "add":
            self.add_margin = AddMarginProduct(emb_size, num_classes, s=s, m=m)
        else:
            raise ValueError(f"margin_type {margin_type!r}: arc | add")
        self.use_focal = use_focal
        self.focal_gamma = focal_gamma

    def forward(self, x: torch.Tensor, labels: torch.Tensor | None = None,
                weights: torch.Tensor | None = None):
        emb = self.model(x)
        if labels is None:
            return emb
        logits = self.add_margin(emb, labels)
        if self.use_focal:
            loss = focal_loss(logits, labels, gamma=self.focal_gamma, weights=weights)
        else:
            loss = cross_entropy(logits, labels, weights=weights)
        return {"loss": loss, "emb": emb, "logits": logits}
