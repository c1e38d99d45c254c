"""Symmetric int8 post-training quantization for the serving trunks
(counterpart of the JAX ``models/quant.py``).

Weights are quantized per output channel and activations per tensor, both
symmetric at scale 127 (no zero point): ``q = clip(round(x * (127 / s)),
-127, 127)`` with ``s`` the max-abs. Two modules carry it:

- :class:`ActQuant`, an activation quantization point. In ``"calibrate"``
  mode it passes ``x`` through and folds ``max|x|`` into its running scale;
  in ``"int8"`` mode it returns ``(int8(x), scale)``.
- :class:`QuantConv`, an ``nn.Conv2d`` that keeps its float ``weight`` (and
  ``bias``), so every float ``state_dict`` and ``weights.py`` bridge still
  loads. It computes in a ``dtype``, float32 or bfloat16 (JAX's default;
  every model passes its own). In ``"calibrate"`` mode it runs the float
  convolution in ``dtype`` and snapshots ``weight_q`` (int8) and ``w_scale``
  (per output channel); in ``"int8"`` mode it takes ``(x_int8, s_x)``,
  multiplies int8 by int8 with exact int32 accumulation (an im2col of the
  int8 input, then ``torch._int_mm``, on the card cuBLASLt's int8 GEMM),
  dequantizes in float32 and casts the result to ``dtype`` once, as the JAX
  package does.

The quant state lives in buffers that a float model lacks (``scale``,
``seen``, ``weight_q``, ``w_scale``), so a float ``state_dict`` loads into a
quant twin with :func:`load_float_state_dict`. A model's mode is set with
:func:`set_quant_mode`; ``models.ptq`` runs the calibrate-then-serve
workflow over it.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import torch
from torch import nn

from ..device import float32_matmuls
from .layers import check_dtype

QUANT_MODES = ("calibrate", "int8")
# ``torch._int_mm`` on a CUDA device takes more than 16 rows and K and N that
# are multiples of 8; the int8 route always pads with zeros to these (exact)
_CUDA_MIN_ROWS, _CUDA_ALIGN = 17, 8


def _check_mode(mode: str | None) -> str | None:
    if mode is not None and mode not in QUANT_MODES:
        raise ValueError(f"quant mode {mode!r}: expected None, 'calibrate' or 'int8'")
    return mode


def quantize_symmetric(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x * (127 / scale)), -127, 127)`` as int8; ``scale`` is the
    float32 max-abs (a scalar, or broadcastable to ``x``). ``127 / scale`` is
    formed first and as a true division, as in JAX (``torch``'s ``127.0 /
    tensor`` would take the reciprocal and multiply); ``torch.round`` rounds
    half to even, as ``jnp.round``."""
    q = torch.round(x.float() * (scale.new_tensor(127.0) / scale))
    return q.clamp(-127.0, 127.0).to(torch.int8)


def dequantize(xq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 -> float32 as the JAX ``resnet._dequant``: ``xq * (scale / 127)``."""
    return xq.float() * (scale / scale.new_tensor(127.0))


class ActQuant(nn.Module):
    """Activation quantization point with a running max-abs ``scale``.

    ``"calibrate"``: returns ``(x, scale)`` unchanged and sets ``scale =
    max(seen ? scale : 0, max(max|x|, 1e-6))``, then ``seen = True``: the first
    batch replaces the initial value, later ones widen it (JAX's ``seen``
    flag). ``"int8"``: returns ``(quantize_symmetric(x, scale), scale)``.
    """

    def __init__(self, mode: str | None = None):
        super().__init__()
        self.mode = _check_mode(mode)
        self.register_buffer("scale", torch.ones((), dtype=torch.float32))
        self.register_buffer("seen", torch.zeros((), dtype=torch.bool))

    def forward(self, x: torch.Tensor):
        if self.mode == "calibrate":
            with torch.no_grad():
                observed = x.detach().float().abs().amax().clamp_min(1e-6)
                prev = torch.where(self.seen, self.scale, torch.zeros_like(self.scale))
                self.scale.copy_(torch.maximum(prev, observed))
                self.seen.fill_(True)
            return x, self.scale
        if self.mode != "int8":
            raise RuntimeError("ActQuant: set a quant mode ('calibrate' or 'int8') first")
        return quantize_symmetric(x, self.scale), self.scale


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] >= size:
        return t
    shape = list(t.shape)
    shape[dim] = size - t.shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim)


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 @ b_t.T`` for ``b_t (N, K) int8`` -> ``(M, N)`` int32,
    summed exactly in int32 (``torch._int_mm``). Rows are zero-padded to more
    than 16 and K and N to multiples of 8, the shapes cuBLASLt's int8 GEMM
    takes, on every device; zeros add nothing, so the product is the same,
    and an aligned operand is used as it is. Raises where ``torch._int_mm``
    does: there is no float fallback."""
    M, K = a.shape
    N = b_t.shape[0]
    k8 = -(-K // _CUDA_ALIGN) * _CUDA_ALIGN
    n8 = -(-N // _CUDA_ALIGN) * _CUDA_ALIGN
    a = _pad_to(_pad_to(a, 1, k8), 0, max(M, _CUDA_MIN_ROWS))
    b_t = _pad_to(_pad_to(b_t, 1, k8), 0, n8)
    return torch._int_mm(a.contiguous(), b_t.contiguous().t())[:M, :N]


def im2col(x: torch.Tensor, kernel_size: tuple[int, int], stride: tuple[int, int],
           padding: tuple[int, int]) -> tuple[torch.Tensor, int, int]:
    """int8 ``x (B, C, H, W)`` (any strides) -> ``(cols (B * Ho * Wo, C * kh *
    kw), Ho, Wo)``, columns in the ``(C, kh, kw)`` order of a flattened
    ``(O, C, kh, kw)`` weight. The padding is the quantized zero, so it stays
    exact. A 1x1 convolution without padding is a strided view of the NHWC
    input (a copy only where the input is not channels-last)."""
    B, C, H, W = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel_size, stride, padding
    xh = x.permute(0, 2, 3, 1)
    if kh == kw == 1 and ph == pw == 0:
        cols = xh[:, ::sh, ::sw]
        return cols.reshape(-1, C), cols.shape[1], cols.shape[2]
    if ph or pw:
        xp = xh.new_zeros((B, H + 2 * ph, W + 2 * pw, C))
        xp[:, ph:ph + H, pw:pw + W] = xh
        xh = xp
    cols = xh.unfold(1, kh, sh).unfold(2, kw, sw)        # (B, Ho, Wo, C, kh, kw)
    Ho, Wo = cols.shape[1], cols.shape[2]
    return cols.reshape(B * Ho * Wo, C * kh * kw), Ho, Wo


def int8_conv2d_acc(xq: torch.Tensor, weight_q: torch.Tensor, stride, padding) -> torch.Tensor:
    """The int32 accumulators of an int8 convolution: ``(B, Ho, Wo, O)``."""
    O = weight_q.shape[0]
    cols, Ho, Wo = im2col(xq, tuple(weight_q.shape[2:]), stride, padding)
    acc = int_mm(cols, weight_q.reshape(O, -1))
    return acc.reshape(xq.shape[0], Ho, Wo, O)


class QuantConv(nn.Conv2d):
    """``nn.Conv2d`` (float ``weight`` and ``bias``, torchvision names) with an
    int8 execution path, computing in ``dtype`` (the JAX ``QuantConv.dtype``,
    bfloat16 by default as there; parameters and quant state stay float32).

    ``"calibrate"``: ``w_scale = max(max|weight| per output channel, 1e-12)``
    and ``weight_q = quantize_symmetric(weight, w_scale)`` are snapshotted,
    and the float model's own op runs with TF32 off: the convolution of the
    input and weight cast to ``dtype``, the bias added in ``dtype``
    (``models/layers.py``; JAX ``quant.py:119-128``). ``"int8"``:
    ``forward(x_int8, s_x)`` computes the int32 accumulators ``yq``
    (:func:`int8_conv2d_acc`), then ``y = float(yq) * ((s_x * w_scale) * (1 /
    (127 * 127))) + bias`` in float32, cast to ``dtype`` once (JAX
    ``quant.py:136-143``). The output is NCHW with channels-last strides, so
    that a following 1x1 convolution reads it without a copy.
    """

    def __init__(self, *args, mode: str | None = None, dtype: torch.dtype = torch.bfloat16,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.mode = _check_mode(mode)
        self.compute_dtype = check_dtype(dtype)
        self.register_buffer("weight_q", torch.zeros(self.weight.shape, dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(self.out_channels, dtype=torch.float32))

    @torch.no_grad()
    def snapshot(self) -> None:
        """``w_scale`` and ``weight_q`` from the current float weight."""
        w = self.weight.detach()
        self.w_scale.copy_(w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12))
        self.weight_q.copy_(quantize_symmetric(w, self.w_scale[:, None, None, None]))

    def forward(self, x: torch.Tensor, s_x: torch.Tensor | None = None) -> torch.Tensor:
        if self.mode == "calibrate":
            self.snapshot()
            dt = self.compute_dtype
            with float32_matmuls():
                if dt == torch.float32:
                    return super().forward(x.float())
                y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
                return y if self.bias is None else y + self.bias.to(dt)[:, None, None]
        if self.mode != "int8":
            raise RuntimeError("QuantConv: set a quant mode ('calibrate' or 'int8') first")
        if x.dtype != torch.int8 or s_x is None:
            raise TypeError("QuantConv in int8 mode takes ActQuant's (x_int8, scale)")
        yq = int8_conv2d_acc(x, self.weight_q, self.stride, self.padding)
        scale = (s_x * self.w_scale) * (1.0 / (127.0 * 127.0))
        y = yq.float() * scale
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.compute_dtype).permute(0, 3, 1, 2)


def quant_modules(model: nn.Module) -> Iterator[nn.Module]:
    return (m for m in model.modules() if isinstance(m, (ActQuant, QuantConv)))


def set_quant_mode(model: nn.Module, mode: str) -> nn.Module:
    """Put every :class:`ActQuant` and :class:`QuantConv` of ``model`` in
    ``mode`` (``"calibrate"`` or ``"int8"``); returns ``model``."""
    _check_mode(mode)
    for m in quant_modules(model):
        m.mode = mode
    return model


@torch.no_grad()
def seed_calibration(model: nn.Module) -> nn.Module:
    """The quant state a calibration starts from, as the JAX ``PTQServing``
    leaves it after the calibrate twin's ``init`` on zeros: under flax's
    fresh initialisation (zero biases and norm shifts) the serving trunks
    map zeros to zeros, so every ``ActQuant`` has observed 0 and holds the
    floor 1e-6 with ``seen`` set; every ``QuantConv`` snapshots its weights
    (JAX snapshots flax's random ones there, which the first calibrate batch
    replaces)."""
    for m in quant_modules(model):
        if isinstance(m, ActQuant):
            m.scale.fill_(1e-6)
            m.seen.fill_(True)
        else:
            m.snapshot()
    return model


def quant_state(model: nn.Module) -> dict[str, torch.Tensor]:
    """The quant buffers of ``model`` (``scale``, ``seen``, ``weight_q``,
    ``w_scale``) by ``state_dict`` name."""
    return {f"{name}.{b}" if name else b: t for name, m in model.named_modules()
            if isinstance(m, (ActQuant, QuantConv)) for b, t in m.named_buffers(recurse=False)}


def load_float_state_dict(model: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> nn.Module:
    """Load a float model's ``state_dict`` into its quant twin: a non-strict
    load that raises unless the keys left out are exactly the twin's quant
    buffers (and nothing is unexpected)."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    quant = set(quant_state(model))
    stray = [k for k in missing if k not in quant]
    if stray or unexpected:
        raise KeyError(f"not a float twin's state_dict: missing {stray}, "
                       f"unexpected {list(unexpected)}")
    return model
