"""Swin Transformer (counterpart of the JAX ``models/swin.py``).

Windowed self-attention with a relative position bias, shifted windows by a
cyclic roll with additive -1e9 masks on the wrapped rows and columns, patch
merging as space-to-depth plus a linear projection, 4 stages of alternating
regular and shifted blocks, and a mean-pool + LayerNorm + Linear head. The
presets ``swin_t/s/b/l`` are the JAX package's.

``forward`` takes NCHW images; inside, tokens stay channels-last
``(B, H, W, C)``. ``features_only`` returns the NCHW stage outputs
``{'c2'..'c5'}`` for :class:`~.fpn.BackboneWithFPN`.

The ``state_dict`` keys are the reference's (berniwal) layout, the one the
JAX ``utils/torch_convert.py::convert_swin`` reads:
``stage{s}.patch_partition.linear``, ``stage{s}.layers.{i}.{0|1}.
attention_block.fn.norm``, ``...attention_block.fn.fn.{to_qkv,
pos_embedding,to_out}``, ``...mlp_block.fn.norm``, ``...mlp_block.fn.fn.net.
{0,2}`` and ``mlp_head.{0,1}``; so a reference checkpoint loads with
``strict=True``. The reference also stores each shifted block's two masks
(``upper_lower_mask``, ``left_right_mask``, fixed by the window size); the
port computes them, and a load checks that incoming ones mask the same
entries and drops them.

``dtype`` (float32, the default, or bfloat16) is the JAX modules' compute
``dtype``: every Dense layer (``to_qkv``, ``to_out``, the MLP, the patch
merging) computes in it through ``layers.Linear``, so the token stream
between the residual adds is in ``dtype``; every LayerNorm computes in
float32 and returns float32 (flax ``LayerNorm(dtype=float32)``); attention
takes the scores ``q k^T`` as float32 sums of the ``dtype`` operands, adds
the float32 bias and masks, takes the softmax in float32, rounds it to the
values' dtype and sums its product with ``v`` in float32 (JAX
``swin.py:81-133``). The head's LayerNorm and ``head_fc`` stay float32.
Parameters stay float32.

Where flax and torch differ: flax ``nn.gelu`` is the tanh approximation,
flax ``LayerNorm`` has eps 1e-6, and patch merging flattens each patch as
``(c fh fw)``, the channel order of ``F.pixel_unshuffle`` (used here) and of
the reference's ``nn.Unfold``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear

LN_EPS = 1e-6          # flax LayerNorm's default
MASK = -1e9            # the JAX package's additive mask value


def relative_position_index(window_size: int) -> np.ndarray:
    """``(w², w², 2)`` index into the ``(2w - 1, 2w - 1)`` bias table."""
    coords = np.array([[x, y] for x in range(window_size) for y in range(window_size)])
    return coords[None, :, :] - coords[:, None, :] + window_size - 1


def shift_masks(window_size: int, displacement: int) -> tuple[np.ndarray, np.ndarray]:
    """The additive ``(w², w²)`` masks of a shifted window: ``upper_lower``
    keeps the bottom ``displacement`` rows of a window from attending to the
    rest and back, ``left_right`` the same for the right columns."""
    n, d = window_size * window_size, displacement * window_size
    ul = np.zeros((n, n), np.float32)
    ul[-d:, :-d] = MASK
    ul[:-d, -d:] = MASK
    w = window_size
    lr = np.zeros((w, w, w, w), np.float32)
    lr[:, -displacement:, :, :-displacement] = MASK
    lr[:, :-displacement, :, -displacement:] = MASK
    return ul, lr.reshape(n, n)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside ``window_size`` x ``window_size``
    windows of a ``(B, H, W, dim)`` token map; ``shifted`` rolls the map by
    half a window first and back after, and masks the pairs the roll brought
    together: the bottom row of windows takes ``upper_lower``, the rightmost
    column ``left_right``, with windows ordered ``(nh nw)``."""

    def __init__(self, dim: int, heads: int, head_dim: int, shifted: bool, window_size: int,
                 relative_pos_embedding: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.scale = head_dim ** -0.5
        self.window_size, self.shifted = window_size, shifted
        self.relative_pos_embedding = relative_pos_embedding
        self.to_qkv = Linear(dim, inner * 3, bias=False, dtype=dtype)
        w = window_size
        if relative_pos_embedding:
            self.pos_embedding = nn.Parameter(torch.randn(2 * w - 1, 2 * w - 1))
            idx = relative_position_index(w)
            self.register_buffer("rel_index", torch.from_numpy(idx[..., 0] * (2 * w - 1)
                                                               + idx[..., 1]), persistent=False)
        else:
            self.pos_embedding = nn.Parameter(torch.randn(w * w, w * w))
        self.to_out = Linear(inner, dim, dtype=dtype)
        if shifted:
            ul, lr = shift_masks(w, w // 2)
            self.register_buffer("ul_mask", torch.from_numpy(ul), persistent=False)
            self.register_buffer("lr_mask", torch.from_numpy(lr), persistent=False)
            self._register_load_state_dict_pre_hook(self._drop_reference_masks)

    def _drop_reference_masks(self, state_dict, prefix, *args) -> None:
        """Take the reference's stored masks out of ``state_dict``, after
        checking that they mask the entries the port's own masks do."""
        for ref_name, own in (("upper_lower_mask", self.ul_mask),
                              ("left_right_mask", self.lr_mask)):
            stored = state_dict.pop(prefix + ref_name, None)
            if stored is not None and not torch.equal(stored.to(own.device) < MASK / 2,
                                                      own < MASK / 2):
                raise ValueError(f"{prefix}{ref_name} masks other entries than a window of "
                                 f"{self.window_size} shifted by {self.window_size // 2}")

    def bias(self) -> torch.Tensor:
        """The ``(w², w²)`` position bias: the relative table gathered as
        ``table[idx[..., 0], idx[..., 1]]``, or the dense table itself."""
        if self.relative_pos_embedding:
            return self.pos_embedding.reshape(-1)[self.rel_index]
        return self.pos_embedding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, d = self.window_size, self.window_size // 2
        if self.shifted:
            x = torch.roll(x, (-d, -d), dims=(1, 2))
        B, H, W, _ = x.shape
        nh, nw = H // w, W // w
        qkv = self.to_qkv(x).reshape(B, nh, w, nw, w, 3, self.heads, self.head_dim)
        # -> (3, B, heads, nh nw, wh ww, d)
        q, k, v = qkv.permute(5, 0, 6, 1, 3, 2, 4, 7).reshape(
            3, B, self.heads, nh * nw, w * w, self.head_dim).unbind(0)
        # float32 sums of the compute-dtype products (JAX's
        # preferred_element_type=float32): the operands are exact in float32
        dots = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.scale + self.bias()
        if self.shifted:
            win = torch.arange(nh * nw, device=x.device)
            mask = ((win // nw == nh - 1).float()[:, None, None] * self.ul_mask
                    + (win % nw == nw - 1).float()[:, None, None] * self.lr_mask)
            dots = dots + mask
        out = torch.matmul(dots.softmax(dim=-1).to(v.dtype).float(), v.float())
        out = out.reshape(B, self.heads, nh, nw, w, w, self.head_dim).permute(
            0, 2, 4, 3, 5, 1, 6).reshape(B, H, W, self.heads * self.head_dim)
        out = self.to_out(out)
        if self.shifted:
            out = torch.roll(out, (d, d), dims=(1, 2))
        return out


class _PreNorm(nn.Module):
    """``fn(norm(x))``, named as the reference's ``PreNorm``; the norm in
    float32."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x.float()))


class _Residual(nn.Module):
    """``x + fn(x)``, named as the reference's ``Residual``."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fn(x)


class _FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = nn.Sequential(Linear(dim, hidden, dtype=dtype), nn.GELU(approximate="tanh"),
                                 Linear(hidden, dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class SwinBlock(nn.Module):
    """Pre-norm window attention and a 4x GELU MLP, each residual."""

    def __init__(self, dim: int, heads: int, head_dim: int, mlp_dim: int, shifted: bool,
                 window_size: int, relative_pos_embedding: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention_block = _Residual(_PreNorm(dim, WindowAttention(
            dim, heads, head_dim, shifted, window_size, relative_pos_embedding, dtype)))
        self.mlp_block = _Residual(_PreNorm(dim, _FeedForward(dim, mlp_dim, dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp_block(self.attention_block(x))


class PatchMerging(nn.Module):
    """Space-to-depth by ``downscaling_factor`` and a linear projection:
    NCHW in, ``(B, H/f, W/f, out_channels)`` tokens out."""

    def __init__(self, in_channels: int, out_channels: int, downscaling_factor: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.downscaling_factor = downscaling_factor
        self.linear = Linear(in_channels * downscaling_factor ** 2, out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pixel_unshuffle(x, self.downscaling_factor)   # channels (c fh fw)
        return self.linear(x.permute(0, 2, 3, 1))


class StageModule(nn.Module):
    """Patch merging, then ``layers // 2`` pairs of a regular and a shifted
    block; NCHW in, tokens out."""

    def __init__(self, in_channels: int, hidden_dim: int, layers: int,
                 downscaling_factor: int, num_heads: int, head_dim: int, window_size: int,
                 relative_pos_embedding: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        if layers % 2:
            raise ValueError(f"a stage holds pairs of blocks, not {layers}")
        self.patch_partition = PatchMerging(in_channels, hidden_dim, downscaling_factor, dtype)
        self.layers = nn.ModuleList(
            nn.ModuleList(SwinBlock(hidden_dim, num_heads, head_dim, hidden_dim * 4, shifted,
                                    window_size, relative_pos_embedding, dtype)
                          for shifted in (False, True))
            for _ in range(layers // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_partition(x)
        for regular, shifted in self.layers:
            x = shifted(regular(x))
        return x


class SwinTransformer(nn.Module):
    """4-stage Swin; see the module docstring. ``forward`` raises a
    ``ValueError`` unless H and W are multiples of ``window_size ×
    prod(downscaling_factors)``."""

    def __init__(self, hidden_dim: int = 96, layers: Sequence[int] = (2, 2, 6, 2),
                 heads: Sequence[int] = (3, 6, 12, 24), head_dim: int = 32,
                 window_size: int = 7, downscaling_factors: Sequence[int] = (4, 2, 2, 2),
                 relative_pos_embedding: bool = True, num_classes: int = 0,
                 features_only: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features_only = features_only
        self.divisor = window_size * math.prod(downscaling_factors)
        self.out_channels = {f"c{s + 2}": hidden_dim * 2 ** s for s in range(4)}
        in_ch = 3
        for s in range(4):
            setattr(self, f"stage{s + 1}", StageModule(
                in_ch, hidden_dim * 2 ** s, layers[s], downscaling_factors[s], heads[s],
                head_dim, window_size, relative_pos_embedding, dtype))
            in_ch = hidden_dim * 2 ** s
        if not features_only:
            head = [nn.LayerNorm(in_ch, eps=LN_EPS)]
            if num_classes:
                head.append(nn.Linear(in_ch, num_classes))
            self.mlp_head = nn.Sequential(*head)

    def forward(self, x: torch.Tensor):
        H, W = x.shape[2:]
        if H % self.divisor or W % self.divisor:
            raise ValueError(f"Swin input {H} x {W}: H and W must be multiples of "
                             f"window_size x prod(downscaling_factors) = {self.divisor}")
        feats = {}
        for s in range(4):
            x = getattr(self, f"stage{s + 1}")(x)
            feats[f"c{s + 2}"] = x = x.permute(0, 3, 1, 2)
        if self.features_only:
            return feats
        return self.mlp_head(x.float().mean(dim=(2, 3)))


def swin_t(**kw) -> SwinTransformer:
    return SwinTransformer(hidden_dim=96, layers=(2, 2, 6, 2), heads=(3, 6, 12, 24), **kw)


def swin_s(**kw) -> SwinTransformer:
    return SwinTransformer(hidden_dim=96, layers=(2, 2, 18, 2), heads=(3, 6, 12, 24), **kw)


def swin_b(**kw) -> SwinTransformer:
    return SwinTransformer(hidden_dim=128, layers=(2, 2, 18, 2), heads=(4, 8, 16, 32), **kw)


def swin_l(**kw) -> SwinTransformer:
    return SwinTransformer(hidden_dim=192, layers=(2, 2, 18, 2), heads=(6, 12, 24, 48), **kw)
