"""Feature extractor: ResNet-50 trunk -> 512-d embedding (counterpart of the JAX
``models/embedder.py``).

The reference FE is torchvision ``resnet50`` with ``fc = Linear(2048, 512)``,
so the port is that ResNet with its ``state_dict`` names; ``forward`` takes the
JAX package's NHWC crops. No l2-normalisation here, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from .resnet import ResNet


class EmbeddingModel(ResNet):
    """ResNet with a ``fc`` projection; ``forward(x (B, H, W, 3) NHWC) -> (B, D)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2))


def resnet50_embedder(embedding_dim: int = 512,
                      stage_sizes: tuple[int, ...] = (3, 4, 6, 3)) -> EmbeddingModel:
    """The production FE: ResNet-50 (BatchNorm2d, eval statistics) + ``fc`` to
    ``embedding_dim``. ``stage_sizes`` cuts depth for tests."""
    return EmbeddingModel(stage_sizes=stage_sizes, num_classes=embedding_dim,
                          norm_layer=nn.BatchNorm2d)
