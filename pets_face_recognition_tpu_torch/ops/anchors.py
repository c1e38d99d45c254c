"""RPN anchors (counterpart of the JAX ``ops/anchors.py``), torchvision semantics.

Base anchors are zero-centred ``sizes x aspect_ratios`` boxes; grid anchors put
them at stride-spaced centres, row-major over ``(y, x, anchor)``. The grids are
generated on the device of the caller.
"""

from __future__ import annotations

import numpy as np
import torch


def generate_anchors(sizes: tuple[float, ...], aspect_ratios: tuple[float, ...],
                     ) -> np.ndarray:
    """Zero-centred base anchors ``(len(sizes) * len(aspect_ratios), 4)`` float32.

    torchvision convention: ``h = size * sqrt(ar)``, ``w = size / sqrt(ar)``.
    """
    sizes = np.asarray(sizes, dtype=np.float32)
    aspect_ratios = np.asarray(aspect_ratios, dtype=np.float32)
    h_ratios = np.sqrt(aspect_ratios)
    w_ratios = 1.0 / h_ratios
    ws = (w_ratios[:, None] * sizes[None, :]).reshape(-1)
    hs = (h_ratios[:, None] * sizes[None, :]).reshape(-1)
    return (np.stack([-ws, -hs, ws, hs], axis=1) / 2.0).astype(np.float32)


def multilevel_anchors(feature_sizes: list[tuple[int, int]], strides: list[int],
                       sizes_per_level: tuple[tuple[float, ...], ...],
                       aspect_ratios: tuple[float, ...] = (0.5, 1.0, 2.0),
                       device: str | torch.device = "cpu") -> torch.Tensor:
    """Grid anchors of every FPN level, concatenated: ``(sum_l H_l*W_l*A, 4)``."""
    per_level = []
    for (fh, fw), stride, sizes in zip(feature_sizes, strides, sizes_per_level):
        base = torch.from_numpy(generate_anchors(tuple(sizes), aspect_ratios)).to(device)
        sy = torch.arange(fh, dtype=torch.float32, device=device) * stride
        sx = torch.arange(fw, dtype=torch.float32, device=device) * stride
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        shifts = torch.stack([gx, gy, gx, gy], dim=-1).reshape(-1, 1, 4)
        per_level.append((shifts + base[None, :, :]).reshape(-1, 4))
    return torch.cat(per_level, dim=0)
