"""ResNet backbones (counterpart of the JAX ``models/resnet.py``), NCHW inside:
ResNet-50 of bottlenecks, ResNet-18 and -34 of basic blocks.

torchvision module and ``state_dict`` names (``conv1``, ``layer1.0.conv2``,
``layer2.0.downsample.0`` ...), stride on each block's first 3x3 conv, BN
epsilon 1e-5, eval-mode statistics (the detection trunk's affine trains, see
``FrozenBatchNorm2d``). The JAX package's space-to-depth stem is an
exact rewrite of the 7x7/s2 conv and stores 7x7 weights, so the port runs the
plain ``Conv2d(3, 64, 7, 2, 3)``.

``dtype`` (``torch.float32``, the default, or ``torch.bfloat16``) is the
JAX ``ResNet.dtype``: the stem and every block's convolutions compute in it,
and so do the norms where they read running statistics (flax's
``use_running_average``: they compute in float32 and round their output to
``dtype``); live BatchNorm in training stays float32 (JAX
``models/resnet.py:221-236``). Parameters and statistics stay float32.

``quant`` (``None``, ``"calibrate"`` or ``"int8"``) builds the serving int8
twin (``models/quant.py``): every block's convolutions become
:class:`~.quant.QuantConv` behind :class:`~.quant.ActQuant` points, under the
same parameter names; the stem, the norms and the ReLUs stay float. A float
``state_dict`` loads into the twin with ``quant.load_float_state_dict`` (a
non-strict load whose only missing keys are the quant buffers).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Sequence

import torch
from torch import nn

from .. import parallel
from .layers import Conv2d, Linear, check_dtype, check_quant_dtype
from .quant import ActQuant, QuantConv, dequantize


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm from fixed statistics with a trainable affine (the JAX
    package's detection trunk norm).

    ``running_mean`` and ``running_var`` are buffers and never change;
    ``weight`` and ``bias`` are parameters. This follows the JAX package, whose
    frozen norm is ``nn.BatchNorm(use_running_average=True)`` with ``scale`` and
    ``bias`` in ``params``, so training differentiates and updates them; it
    departs from torchvision's ``FrozenBatchNorm2d``, which keeps all four as
    buffers. The ``state_dict`` keys are torchvision's either way.

    ``dtype``: it computes in float32 (flax promotes the input to the
    statistics' float32) and rounds its output to ``dtype``, as flax's
    ``nn.BatchNorm(use_running_average=True, dtype=...)``.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = check_dtype(dtype)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x - self.running_mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


class LiveBatchNorm2d(nn.Module):
    """BatchNorm with live statistics, as flax ``nn.BatchNorm`` computes it
    (the MobileNetV3 trunk's norm when it trains from scratch).

    In ``train()`` it normalises with the batch mean and the biased batch
    variance, flax's ``max(E[x^2] - E[x]^2, 0)``, and updates
    ``running_stat = momentum * running_stat + (1 - momentum) * batch_stat``
    with that same biased variance; in ``eval()`` it reads the running
    statistics. ``momentum`` is flax's: the weight of the old statistics
    (torch's ``nn.BatchNorm2d`` takes ``1 - momentum``, updates with the
    unbiased variance and defaults to eps 1e-5, so it is not used here). No
    ``num_batches_tracked``: flax keeps no counter, and the keys are those of
    :class:`FrozenBatchNorm2d`, so a serving twin loads this norm's
    ``state_dict`` strictly.

    Inside a data-parallel step over more than one rank
    (``parallel.data_parallel``) the moments are those of the whole global
    batch, as JAX's sharded jit takes them: the sums of ``x`` and ``x^2``
    go through a differentiable all-reduce, so the backward is the
    whole-batch backward and the running statistics stay equal on every rank.

    ``dtype``: in ``eval()`` the output is rounded to it, as flax's
    ``dtype=self.dtype if use_running_average``; in ``train()`` the norm
    computes in float32 and returns float32 (JAX ``resnet.py:221-236``).
    """

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.99,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.dtype = check_dtype(dtype)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            x = x.float()
            if parallel.shards() > 1:
                mean, mean_sq = parallel.global_moments(x, (0, 2, 3))
            else:
                mean, mean_sq = x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y if self.training else y.to(self.dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck, projection shortcut when needed.

    With ``quant`` (JAX ``Bottleneck(quant=...)``) the block input is
    quantized once (``in_q``) and read by ``conv1``, by the projection
    shortcut and, dequantized as ``xq * (s_x / 127)``, by the identity
    residual (in calibrate mode the identity residual is the float input);
    ``q1`` and ``q2`` sit between the convolutions. ``dtype``: the
    convolutions' compute dtype (``norm_layer`` carries the norms').
    """

    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int,
                 norm_layer: Callable[[int], nn.Module], quant: str | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        check_quant_dtype(quant, dtype)
        out_ch = width * self.expansion
        conv = partial(Conv2d, dtype=dtype) if quant is None else partial(QuantConv, mode=quant)
        self.conv1 = conv(in_ch, width, 1, bias=False)
        self.bn1 = norm_layer(width)
        self.conv2 = conv(width, width, 3, stride, 1, bias=False)
        self.bn2 = norm_layer(width)
        self.conv3 = conv(width, out_ch, 1, bias=False)
        self.bn3 = norm_layer(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                conv(in_ch, out_ch, 1, stride, bias=False), norm_layer(out_ch))
        self.quant = quant is not None
        if self.quant:
            self.in_q, self.q1, self.q2 = (ActQuant(quant) for _ in range(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            return self._forward_quant(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)

    def _forward_quant(self, x: torch.Tensor) -> torch.Tensor:
        xq, s_x = self.in_q(x)
        y = self.relu(self.bn1(self.conv1(xq, s_x)))
        y = self.relu(self.bn2(self.conv2(*self.q1(y))))
        y = self.bn3(self.conv3(*self.q2(y)))
        if self.downsample is not None:
            residual = self.downsample[1](self.downsample[0](xq, s_x))
        elif self.in_q.mode == "int8":
            residual = dequantize(xq, s_x)
        else:
            residual = x
        return self.relu(y + residual)


class BasicBlock(nn.Module):
    """3x3(stride) -> 3x3 block of ResNet-18/34, projection shortcut when
    needed. With ``quant`` the block input is quantized once (``in_q``) and
    read by ``conv1``, by the projection shortcut and, dequantized, by the
    identity residual (the float input in calibrate mode); ``q1`` sits between
    the convolutions (JAX ``BasicBlock(quant=...)``). ``dtype``: the
    convolutions' compute dtype (``norm_layer`` carries the norms')."""

    expansion = 1

    def __init__(self, in_ch: int, width: int, stride: int,
                 norm_layer: Callable[[int], nn.Module], quant: str | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        check_quant_dtype(quant, dtype)
        conv = partial(Conv2d, dtype=dtype) if quant is None else partial(QuantConv, mode=quant)
        self.conv1 = conv(in_ch, width, 3, stride, 1, bias=False)
        self.bn1 = norm_layer(width)
        self.conv2 = conv(width, width, 3, 1, 1, bias=False)
        self.bn2 = norm_layer(width)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or in_ch != width:
            self.downsample = nn.Sequential(
                conv(in_ch, width, 1, stride, bias=False), norm_layer(width))
        self.quant = quant is not None
        if self.quant:
            self.in_q, self.q1 = ActQuant(quant), ActQuant(quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            return self._forward_quant(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)

    def _forward_quant(self, x: torch.Tensor) -> torch.Tensor:
        xq, s_x = self.in_q(x)
        y = self.relu(self.bn1(self.conv1(xq, s_x)))
        y = self.bn2(self.conv2(*self.q1(y)))
        if self.downsample is not None:
            residual = self.downsample[1](self.downsample[0](xq, s_x))
        elif self.in_q.mode == "int8":
            residual = dequantize(xq, s_x)
        else:
            residual = x
        return self.relu(y + residual)


class ResNet(nn.Module):
    """torchvision-compatible ResNet of ``block`` (``Bottleneck`` or
    ``BasicBlock``); ``forward`` takes NCHW.

    ``features_only`` returns ``{'c2'..'c5'}`` NCHW maps (``level_channels``
    wide); otherwise the global average pool, then ``fc`` when
    ``num_classes`` > 0. ``quant`` builds every block's int8 twin (the stem
    and ``fc`` stay float). ``dtype`` is the compute dtype of the stem, the
    blocks, the running-statistics norms (``norm_layer`` is called with
    ``dtype=``) and, unless ``fc_dtype`` is given, ``fc`` (JAX's ``nn.Dense(...,
    dtype=self.dtype)``); the maps come out in ``dtype``.
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 0, features_only: bool = False,
                 norm_layer: Callable[[int], nn.Module] = FrozenBatchNorm2d,
                 quant: str | None = None, block: type[nn.Module] = Bottleneck,
                 dtype: torch.dtype = torch.float32, fc_dtype: torch.dtype | None = None):
        super().__init__()
        check_quant_dtype(quant, dtype)
        norm_layer = partial(norm_layer, dtype=dtype)
        self.features_only = features_only
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = norm_layer(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch = 64
        for stage, (n_blocks, width) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (i == 0 and stage > 0) else 1
                blocks.append(block(in_ch, width, stride, norm_layer, quant, dtype))
                in_ch = width * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.level_channels = tuple(w * block.expansion for w in (64, 128, 256, 512))
        self.out_channels = in_ch
        self.fc = (Linear(in_ch, num_classes, dtype=dtype if fc_dtype is None else fc_dtype)
                   if num_classes else None)

    def forward(self, x: torch.Tensor):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        feats = {}
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            feats[f"c{stage + 2}"] = x
        if self.features_only:
            return feats
        x = x.mean(dim=(2, 3))
        return self.fc(x) if self.fc is not None else x


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


def _small(stage_sizes, num_classes: int, frozen_stats: bool, kw: dict) -> ResNet:
    """A basic-block ResNet; its norm, unless ``norm_layer`` is given, is JAX's
    ``frozen_stats`` choice: frozen statistics, or live BatchNorm at flax
    momentum 0.9."""
    kw.setdefault("norm_layer", FrozenBatchNorm2d if frozen_stats
                  else partial(LiveBatchNorm2d, momentum=0.9))
    return ResNet(stage_sizes=stage_sizes, num_classes=num_classes, block=BasicBlock, **kw)


def resnet34(num_classes: int = 0, frozen_stats: bool = False, **kw) -> ResNet:
    return _small((3, 4, 6, 3), num_classes, frozen_stats, kw)


def resnet18(num_classes: int = 0, frozen_stats: bool = False, **kw) -> ResNet:
    return _small((2, 2, 2, 2), num_classes, frozen_stats, kw)
