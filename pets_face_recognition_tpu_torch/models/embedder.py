"""Feature extractor: ResNet-50 trunk -> 512-d embedding (counterpart of the JAX
``models/embedder.py``).

The reference FE is torchvision ``resnet50`` with ``fc = Linear(2048, 512)``,
so the port is that ResNet with its ``state_dict`` names; ``forward`` takes the
JAX package's NHWC crops. No l2-normalisation here, as in the JAX package.

Its norms are :class:`~.resnet.LiveBatchNorm2d` at flax momentum 0.9, as the
JAX ResNet builds them: in ``train()`` batch statistics with the biased
variance, the running ones moved by ``0.9 old + 0.1 batch``; in ``eval()`` the
running statistics. The ``state_dict`` has no ``num_batches_tracked``.

``dtype`` is the trunk's compute dtype (JAX ``resnet50_embedder(dtype=...)``);
the ``fc`` projection stays float32, on the pooled features cast to float32,
and the embedding is float32 either way.
"""

from __future__ import annotations

from functools import partial

import torch

from .resnet import LiveBatchNorm2d, ResNet

BN_MOMENTUM = 0.9          # the JAX ResNet's nn.BatchNorm(momentum=0.9)


class EmbeddingModel(ResNet):
    """ResNet with a ``fc`` projection; ``forward(x (B, H, W, 3) NHWC) -> (B, D)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2))


def resnet50_embedder(embedding_dim: int = 512,
                      stage_sizes: tuple[int, ...] = (3, 4, 6, 3),
                      quant: str | None = None,
                      dtype: torch.dtype = torch.float32) -> EmbeddingModel:
    """The production FE: ResNet-50 (live BatchNorm, momentum 0.9) + ``fc`` to
    ``embedding_dim``. ``stage_sizes`` cuts depth for tests; ``quant``
    (``"calibrate"`` or ``"int8"``) quantizes the trunk's bottlenecks, while
    the stem and ``fc`` stay float32 (JAX ``resnet50_embedder(quant=...)``);
    ``dtype`` is the trunk's compute dtype, with ``fc`` in float32."""
    return EmbeddingModel(stage_sizes=stage_sizes, num_classes=embedding_dim,
                          norm_layer=partial(LiveBatchNorm2d, momentum=BN_MOMENTUM),
                          quant=quant, dtype=dtype, fc_dtype=torch.float32)
