"""ConvNeXt (counterpart of the JAX ``models/convnext.py``), NCHW.

A 4 x 4 / 4 patchify stem and LayerNorm, then stages of blocks (7 x 7
depthwise conv -> LayerNorm -> 4x pointwise -> GELU -> pointwise -> layer
scale ``gamma``, residual) with a LayerNorm + 2 x 2 / 2 downsampling conv
between stages; ``convnext_tiny`` and ``convnext_small`` are the JAX presets.
``features_only`` returns the NCHW stage outputs ``{'c2'..'c5'}`` for
:class:`~.fpn.BackboneWithFPN`.

``state_dict`` keys follow the JAX module names: ``stem_conv``,
``stem_norm``, ``downsample_norm{s}``, ``downsample_conv{s}``,
``stage{s}_block{b}.{dwconv,norm,pwconv1,pwconv2,gamma}``, ``head_norm``,
``head_fc``; ``pwconv1``/``pwconv2`` are ``Linear`` layers over channels-last
pixels, as flax's ``Dense``.

``dtype`` (float32, the default, or bfloat16) is the JAX modules' compute
``dtype``: the convolutions and the pointwise layers compute in it
(``layers.Conv2d`` / ``layers.Linear``), every LayerNorm computes in float32
and returns float32 (flax ``LayerNorm(dtype=float32)``), and the layer
scale ``gamma`` (float32) brings each block's branch, and so the residual
stream, to float32, as flax promotes it (JAX ``convnext.py:25-60``). The
head's norm and ``head_fc`` stay float32; parameters stay float32.

Where flax and torch differ: the stem and downsampling convolutions use
flax's default ``SAME`` padding, which pads a size that is not a multiple of
the stride (``pad // 2`` before, the rest after), mirrored by ``F.pad``;
LayerNorm normalises over channels with eps 1e-6; GELU is the tanh
approximation.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Linear

LN_EPS = 1e-6          # the JAX model's LayerNorm epsilon


class ChannelNorm(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map (flax's LayerNorm on NHWC),
    in float32."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float().permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class SameConv(Conv2d):
    """A ``kernel_size == stride`` convolution with ``SAME`` padding: each
    spatial size is padded up to a multiple of the stride, ``pad // 2``
    before and the rest after, as ``lax.padtype_to_pads`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, s in zip(reversed(x.shape[2:]), reversed(self.stride)):
            total = -size % s
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads) if any(pads) else x)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = Linear(dim, 4 * dim, dtype=dtype)
        self.pwconv2 = Linear(4 * dim, dim, dtype=dtype)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.dwconv(x).float().permute(0, 2, 3, 1))
        y = self.pwconv2(F.gelu(self.pwconv1(y), approximate="tanh")) * self.gamma
        return x + y.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    """See the module docstring; ``forward`` takes NCHW images."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), num_classes: int = 0,
                 features_only: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depths, self.features_only = tuple(depths), features_only
        self.out_channels = {f"c{s + 2}": d for s, d in enumerate(dims)}
        self.stem_conv = SameConv(3, dims[0], 4, stride=4, dtype=dtype)
        self.stem_norm = ChannelNorm(dims[0])
        for s in range(4):
            if s > 0:
                setattr(self, f"downsample_norm{s}", ChannelNorm(dims[s - 1]))
                setattr(self, f"downsample_conv{s}",
                        SameConv(dims[s - 1], dims[s], 2, stride=2, dtype=dtype))
            for b in range(depths[s]):
                setattr(self, f"stage{s}_block{b}", ConvNeXtBlock(dims[s], dtype=dtype))
        if not features_only:
            self.head_norm = nn.LayerNorm(dims[-1], eps=LN_EPS)
            self.head_fc = nn.Linear(dims[-1], num_classes) if num_classes else None

    def forward(self, x: torch.Tensor):
        x = self.stem_norm(self.stem_conv(x))
        feats = {}
        for s, depth in enumerate(self.depths):
            if s > 0:
                x = getattr(self, f"downsample_conv{s}")(getattr(self, f"downsample_norm{s}")(x))
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x)
            feats[f"c{s + 2}"] = x
        if self.features_only:
            return feats
        x = self.head_norm(x.float().mean(dim=(2, 3)))
        return self.head_fc(x) if self.head_fc is not None else x


def convnext_tiny(**kw) -> ConvNeXt:
    return ConvNeXt(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), **kw)


def convnext_small(**kw) -> ConvNeXt:
    return ConvNeXt(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768), **kw)
