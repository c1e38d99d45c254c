"""Convolution and dense layers that compute in a module ``dtype``, as flax's
``nn.Conv``, ``nn.ConvTranspose`` and ``nn.Dense`` do with ``dtype=...``.

A module's ``dtype`` (one of :data:`COMPUTE_DTYPES`) is the type it computes
in; its parameters stay float32, so ``state_dict`` names and ``weights.py``
are unchanged. At each call the layer casts its input, weight and bias to
``dtype`` (flax's ``promote_dtype``), runs the product, whose result is
rounded to ``dtype``, then adds the bias in ``dtype``: two roundings, at the
points where XLA rounds flax's product and its bias add. In float32 a layer
is the plain ``torch.nn`` one (an input of another type is cast to float32
first, as flax casts a bfloat16 activation reaching a float32 layer).
This is explicit code in each layer, not ``torch.autocast``, so that the
rounding points are JAX's and the tests can hold them there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def check_dtype(dtype: torch.dtype) -> torch.dtype:
    """``dtype`` if it is a compute dtype of the models, else ``ValueError``."""
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"model dtype {dtype}: expected one of {COMPUTE_DTYPES}")
    return dtype


def _bias_after(y: torch.Tensor, bias: torch.Tensor | None, dtype: torch.dtype,
                dim: int) -> torch.Tensor:
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[dim] = -1
    return y + bias.to(dtype).reshape(shape)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (see the module docstring)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = check_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x.float())
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return _bias_after(y, self.bias, dt, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``dtype`` (see the module docstring)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = check_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x.float())
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding,
                               self.output_padding, self.groups, self.dilation)
        return _bias_after(y, self.bias, dt, 1)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (see the module docstring)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = check_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x.float())
        return _bias_after(F.linear(x.to(dt), self.weight.to(dt)), self.bias, dt, -1)
