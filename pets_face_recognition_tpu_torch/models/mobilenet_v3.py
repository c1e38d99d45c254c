"""MobileNetV3-Large (counterpart of the JAX ``models/mobilenet_v3.py``), NCHW.

The JAX package's table and taps: a 3x3/s2 stem (16 channels), 15 inverted
residual blocks (expand 1x1, depthwise kxk, optional squeeze-excite, project
1x1, a residual where the stride is 1 and the widths match), BN epsilon 1e-3
everywhere; ``features_only`` returns the outputs of blocks 2, 5, 11 and 14
as ``c2..c5`` (24, 40, 112 and 160 channels at strides 4, 8, 16 and 32).
Module names follow the JAX ones (``stem``, ``bn_stem``, ``blocks.{i}.dwconv``
...), so ``weights.mobilenet_state_dict`` is a renaming.

Two departures from torchvision's ``mobilenet_v3_large`` that the port keeps,
since the JAX package has them: the squeeze width is ``max(exp // 4, 8)``
(torchvision rounds ``exp // 4`` up to a multiple of 8: 18 against 24 at
exp = 72), and ``c5`` is block 14's 160-channel output, not the 960-channel
last conv. A torchvision checkpoint does not load.

Hard sigmoid and hard swish are the JAX formula, ``clip(x / 6 + 0.5, 0, 1)``
(``F.hardsigmoid`` computes ``relu6(x + 3) / 6``, which rounds differently).
The JAX package runs its stem as a space-to-depth 2x2 convolution on even
sizes, an exact rewrite of the 3x3/s2 one; the port runs the plain one.

The norm is :class:`FrozenBatchNorm2d` (``frozen_stats=True``, running
statistics always, as ``use_running_average=True``) or :class:`LiveBatchNorm2d`
(flax ``nn.BatchNorm``: batch statistics and a running-statistics update in
``train()``, the running statistics in ``eval()``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from .resnet import FrozenBatchNorm2d, LiveBatchNorm2d

# (expansion, out, kernel, stride, squeeze-excite, hard swish): the JAX table
MBV3_LARGE = (
    (16, 16, 3, 1, False, False),
    (64, 24, 3, 2, False, False),
    (72, 24, 3, 1, False, False),     # c2 (stride 4)
    (72, 40, 5, 2, True, False),
    (120, 40, 5, 1, True, False),
    (120, 40, 5, 1, True, False),     # c3 (stride 8)
    (240, 80, 3, 2, False, True),
    (200, 80, 3, 1, False, True),
    (184, 80, 3, 1, False, True),
    (184, 80, 3, 1, False, True),
    (480, 112, 3, 1, True, True),
    (672, 112, 3, 1, True, True),     # c4 (stride 16)
    (672, 160, 5, 2, True, True),
    (960, 160, 5, 1, True, True),
    (960, 160, 5, 1, True, True),     # c5 (stride 32)
)
TAPS = {2: "c2", 5: "c3", 11: "c4", 14: "c5"}
BN_EPS = 1e-3


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


class SqueezeExcite(nn.Module):
    """Spatial mean -> 1x1 conv (bias) -> ReLU -> 1x1 conv (bias) -> hard
    sigmoid, multiplied into the input."""

    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True)))
        return x * hard_sigmoid(self.fc2(s))


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, exp: int, out: int, kernel: int, stride: int,
                 use_se: bool, use_hs: bool, norm: Callable[[int], nn.Module]):
        super().__init__()
        self.act = hard_swish if use_hs else torch.relu
        self.residual = stride == 1 and inp == out
        if exp != inp:
            self.expand = nn.Conv2d(inp, exp, 1, bias=False)
            self.bn_expand = norm(exp)
        else:
            self.expand = None
        self.dwconv = nn.Conv2d(exp, exp, kernel, stride, (kernel - 1) // 2, groups=exp,
                                bias=False)
        self.bn_dw = norm(exp)
        self.se = SqueezeExcite(exp, max(exp // 4, 8)) if use_se else None
        self.project = nn.Conv2d(exp, out, 1, bias=False)
        self.bn_project = norm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand is not None:
            y = self.act(self.bn_expand(self.expand(y)))
        y = self.act(self.bn_dw(self.dwconv(y)))
        if self.se is not None:
            y = self.se(y)
        y = self.bn_project(self.project(y))
        return y + x if self.residual else y


class MobileNetV3Large(nn.Module):
    """``forward`` takes NCHW. ``features_only`` returns ``{'c2'..'c5'}``;
    otherwise the 960-channel head conv, the global mean, ``head_fc1`` (1280,
    hard swish) and, when ``num_classes`` > 0, ``head_fc2``.

    ``bn_momentum`` is flax's (the weight of the old running statistics):
    0.99 by default, 0.9 in the keypoint training config.
    """

    def __init__(self, num_classes: int = 0, features_only: bool = False,
                 frozen_stats: bool = False, bn_momentum: float = 0.99):
        super().__init__()
        self.features_only = features_only

        def norm(c: int) -> nn.Module:
            if frozen_stats:
                return FrozenBatchNorm2d(c, eps=BN_EPS)
            return LiveBatchNorm2d(c, eps=BN_EPS, momentum=bn_momentum)

        self.stem = nn.Conv2d(3, 16, 3, 2, 1, bias=False)
        self.bn_stem = norm(16)
        blocks, inp = [], 16
        for exp, out, k, s, se, hs in MBV3_LARGE:
            blocks.append(InvertedResidual(inp, exp, out, k, s, se, hs, norm))
            inp = out
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = {TAPS[i]: MBV3_LARGE[i][1] for i in TAPS}
        if not features_only:
            self.head_conv = nn.Conv2d(inp, 960, 1, bias=False)
            self.bn_head = norm(960)
            self.head_fc1 = nn.Linear(960, 1280)
            self.head_fc2 = nn.Linear(1280, num_classes) if num_classes else None

    def forward(self, x: torch.Tensor):
        x = hard_swish(self.bn_stem(self.stem(x)))
        feats = {}
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in TAPS:
                feats[TAPS[i]] = x
        if self.features_only:
            return feats
        x = hard_swish(self.bn_head(self.head_conv(x))).mean(dim=(2, 3))
        x = hard_swish(self.head_fc1(x))
        return self.head_fc2(x) if self.head_fc2 is not None else x

