"""Feature Pyramid Network (counterpart of the JAX ``models/fpn.py``), NCHW.

torchvision ``FeaturePyramidNetwork`` names in the flat (torchvision 0.12)
layout: ``inner_blocks.{i}`` lateral 1x1 convs, ``layer_blocks.{i}`` 3x3
smoothing convs; nearest 2x top-down path cropped to the lateral's size, and a
stride-2 max-pool ``p6`` for the RPN. With ``quant`` the lateral and
smoothing convolutions are :class:`~.quant.QuantConv`, each behind its own
:class:`~.quant.ActQuant` (``inner_q.{i}``, ``layer_q.{i}``), as the JAX
``FPN(quant=...)``; the top-down adds stay float.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, check_quant_dtype
from .quant import ActQuant, QuantConv


class FPN(nn.Module):
    """``{'c2'..'c5'}`` -> ``{'p2'..'p6'}`` with ``out_channels`` everywhere."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256,
                 in_levels: Sequence[str] = ("c2", "c3", "c4", "c5"),
                 add_p6: bool = True, quant: str | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        check_quant_dtype(quant, dtype)
        self.in_levels = tuple(in_levels)
        self.add_p6 = add_p6
        conv = partial(Conv2d, dtype=dtype) if quant is None else partial(QuantConv, mode=quant)
        self.inner_blocks = nn.ModuleList(conv(c, out_channels, 1) for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            conv(out_channels, out_channels, 3, padding=1) for _ in in_channels)
        self.quant = quant is not None
        if self.quant:
            self.inner_q = nn.ModuleList(ActQuant(quant) for _ in in_channels)
            self.layer_q = nn.ModuleList(ActQuant(quant) for _ in in_channels)

    def _conv(self, kind: str, i: int, x: torch.Tensor) -> torch.Tensor:
        blk = getattr(self, f"{kind}_blocks")[i]
        return blk(*getattr(self, f"{kind}_q")[i](x)) if self.quant else blk(x)

    def forward(self, feats: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        laterals = [self._conv("inner", i, feats[lvl]) for i, lvl in enumerate(self.in_levels)]
        merged = [laterals[-1]]
        for lat in laterals[-2::-1]:
            up = F.interpolate(merged[0], scale_factor=2, mode="nearest")
            merged.insert(0, lat + up[:, :, : lat.shape[2], : lat.shape[3]])
        outs = {f"p{int(lvl[1:])}": self._conv("layer", i, m)
                for i, (lvl, m) in enumerate(zip(self.in_levels, merged))}
        if self.add_p6:
            top = int(self.in_levels[-1][1:])
            outs[f"p{top + 1}"] = F.max_pool2d(outs[f"p{top}"], 1, 2)
        return outs


class BackboneWithFPN(nn.Module):
    """``body`` (any ``features_only`` trunk: NCHW images -> ``{'c2'..}``) +
    ``fpn``: NCHW images -> pyramid. ``in_channels`` are the widths of the
    body's ``in_levels`` maps: ResNet-50's by default; the MobileNetV3
    detector takes ``(112, 160)`` over ``("c4", "c5")``, giving p4, p5 and
    the max-pool p6 (JAX ``BackboneWithFPN(..., in_levels=("c4", "c5"))``).
    ``quant`` quantizes the FPN's convolutions only; the body carries its own.
    ``dtype`` is the FPN's compute dtype; the body carries its own."""

    def __init__(self, body: nn.Module, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 in_levels: Sequence[str] = ("c2", "c3", "c4", "c5"),
                 out_channels: int = 256, quant: str | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(in_channels) != len(in_levels):
            raise ValueError(f"in_channels {in_channels} do not match in_levels {in_levels}")
        self.body = body
        self.fpn = FPN(in_channels, out_channels, in_levels, quant=quant, dtype=dtype)
        self.out_channels = out_channels

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.fpn(self.body(x))

