"""FPN multilevel RoIAlign (counterpart of the JAX ``ops/roi_align.py`` and of
``ops/pallas_roi_align.py::multilevel_roi_align_pallas``).

Layouts are the JAX package's: NHWC ``(B, H_l, W_l, C)`` levels, ``(K, 4)``
xyxy RoIs in image coordinates, ``(K, oh, ow, C)`` output. ``roi_levels`` plus
``multilevel_roi_align`` (one gather over the flattened pyramid) are the plain
PyTorch version of kernel K3; ``multilevel_roi_align_cuda`` is its wrapper,
which launches ``csrc/roi_align.cu`` for CUDA tensors and calls the plain
version for CPU tensors. Numerics: torchvision ``aligned=False`` with a fixed
``sampling_ratio``.
"""

from __future__ import annotations

import torch

from .. import kernels


def roi_levels(rois: torch.Tensor, min_level: int, max_level: int,
               canonical_scale: float = 224.0, canonical_level: int = 4,
               ) -> torch.Tensor:
    """FPN level index (0-based from ``min_level``) per RoI, int32.

    torchvision ``LevelMapper``: ``floor(k0 + log2(sqrt(area) / 224) + 1e-6)``
    clamped to ``[min_level, max_level]``; zero-area boxes map to ``min_level``.
    """
    rois = rois.float()
    area = (rois[:, 2] - rois[:, 0]).clamp(min=0) * (rois[:, 3] - rois[:, 1]).clamp(min=0)
    lvl = torch.floor(canonical_level + torch.log2(torch.sqrt(area) / canonical_scale) + 1e-6)
    return lvl.clamp(min_level, max_level).to(torch.int32) - min_level


def _sample_offsets(n: int, s: int, device) -> torch.Tensor:
    """``i + (p + 0.5) / s`` for output cell ``i`` and sample ``p``: ``(n * s,)``."""
    off = (torch.arange(s, device=device, dtype=torch.float32) + 0.5) / s
    return (torch.arange(n, device=device, dtype=torch.float32)[:, None]
            + off[None, :]).reshape(-1)


def multilevel_roi_align(features: list[torch.Tensor], rois: torch.Tensor,
                         roi_batch_idx: torch.Tensor, output_size: tuple[int, int],
                         strides: tuple[int, ...], sampling_ratio: int = 2,
                         canonical_scale: float = 224.0, canonical_level: int = 4,
                         min_level: int = 2, max_level: int = 5) -> torch.Tensor:
    """Plain K3: each RoI pools ``output_size`` from its assigned level only.

    ``features``: NHWC levels ordered ``p{min_level}..p{max_level}``;
    ``strides``: image-to-feature stride per level. Returns ``(K, oh, ow, C)``.
    """
    oh, ow = output_size
    s = sampling_ratio
    B, _, _, C = features[0].shape
    K = rois.shape[0]
    dev = rois.device

    sizes = [(f.shape[1], f.shape[2]) for f in features]
    flat = torch.cat([f.float().reshape(B, -1, C) for f in features], dim=1)
    offsets, off = [], 0
    for h, w in sizes:
        offsets.append(off)
        off += h * w
    P = off
    hs = torch.tensor([h for h, _ in sizes], dtype=torch.int64, device=dev)
    ws = torch.tensor([w for _, w in sizes], dtype=torch.int64, device=dev)
    offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
    scales = torch.tensor([1.0 / st for st in strides], dtype=torch.float32, device=dev)

    rois = rois.float()
    lvl = roi_levels(rois, min_level, max_level, canonical_scale,
                     canonical_level).long()
    scale, H, W, base = scales[lvl], hs[lvl], ws[lvl], offs[lvl]

    boxes = rois * scale[:, None]
    x1, y1 = boxes[:, 0], boxes[:, 1]
    roi_w = (boxes[:, 2] - boxes[:, 0]).clamp(min=1.0)
    roi_h = (boxes[:, 3] - boxes[:, 1]).clamp(min=1.0)
    bin_h = roi_h / oh
    bin_w = roi_w / ow
    ys = y1[:, None] + _sample_offsets(oh, s, dev)[None, :] * bin_h[:, None]
    xs = x1[:, None] + _sample_offsets(ow, s, dev)[None, :] * bin_w[:, None]
    yy = ys[:, :, None].expand(K, oh * s, ow * s)
    xx = xs[:, None, :].expand(K, oh * s, ow * s)
    H3, W3 = H[:, None, None], W[:, None, None]

    oob = (yy <= -1.0) | (yy >= H3.float()) | (xx <= -1.0) | (xx >= W3.float())
    yyc = yy.clamp(min=0.0)
    xxc = xx.clamp(min=0.0)
    # clamp before the int cast: out-of-range samples are masked by ``oob``
    y_low = torch.minimum(torch.floor(yyc), (H3 - 1).float()).long()
    x_low = torch.minimum(torch.floor(xxc), (W3 - 1).float()).long()
    y_edge = y_low >= H3 - 1
    x_edge = x_low >= W3 - 1
    y_high = torch.where(y_edge, y_low, y_low + 1)
    x_high = torch.where(x_edge, x_low, x_low + 1)
    zero = torch.zeros((), device=dev)
    ly = torch.where(y_edge, zero, yyc - y_low.float())
    lx = torch.where(x_edge, zero, xxc - x_low.float())
    hy, hx = 1.0 - ly, 1.0 - lx

    big = flat.reshape(B * P, C)
    bidx = roi_batch_idx.long()[:, None, None]
    base3 = base[:, None, None]

    def take(yi, xi):
        idx = bidx * P + base3 + yi * W3 + xi
        return big[idx.reshape(-1)].reshape(K, oh * s, ow * s, C)

    val = (take(y_low, x_low) * (hy * hx)[..., None]
           + take(y_low, x_high) * (hy * lx)[..., None]
           + take(y_high, x_low) * (ly * hx)[..., None]
           + take(y_high, x_high) * (ly * lx)[..., None])
    val = torch.where(oob[..., None], zero, val)
    return val.reshape(K, oh, s, ow, s, C).mean(dim=(2, 4))


def multilevel_roi_align_cuda(features: list[torch.Tensor], rois: torch.Tensor,
                              roi_batch_idx: torch.Tensor,
                              output_size: tuple[int, int], strides: tuple[int, ...],
                              sampling_ratio: int = 2, canonical_scale: float = 224.0,
                              canonical_level: int = 4, min_level: int = 2,
                              max_level: int = 5) -> torch.Tensor:
    """K3 wrapper: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

    Same arguments and result as :func:`multilevel_roi_align`; at most 4 levels.
    The level of each RoI comes from :func:`roi_levels`, as in the plain version.
    """
    if rois.device.type == "cpu":
        return multilevel_roi_align(features, rois, roi_batch_idx, output_size,
                                    strides, sampling_ratio, canonical_scale,
                                    canonical_level, min_level, max_level)
    n = len(features)
    if not 1 <= n <= 4 or len(strides) < n or max_level - min_level + 1 != n:
        raise ValueError(f"roi_align: 1-4 levels spanning min..max_level, got {n}")
    B, _, _, C = features[0].shape
    for i, f in enumerate(features):
        kernels.check_cuda_f32(f"roi_align level {i}", f, 4)
        if f.shape[0] != B or f.shape[3] != C or f.device != rois.device:
            raise ValueError("roi_align: levels must share B, C and the device")
    kernels.check_cuda_f32("roi_align rois", rois, 2)
    K = rois.shape[0]
    if rois.shape[1] != 4:
        raise ValueError(f"roi_align rois: expected (K, 4), got {tuple(rois.shape)}")
    if roi_batch_idx.shape != (K,) or roi_batch_idx.device != rois.device:
        raise ValueError("roi_align batch index: expected (K,) on the rois' device")
    oh, ow = output_size
    out = torch.empty((K, oh, ow, C), dtype=torch.float32, device=rois.device)
    if K == 0:
        return out
    bidx = roi_batch_idx.to(torch.int32).contiguous()
    lvl = roi_levels(rois, min_level, max_level, canonical_scale,
                     canonical_level).contiguous()
    pad = 4 - n
    ptrs = [kernels.ptr(f) for f in features] + [None] * pad
    hs = [f.shape[1] for f in features] + [0] * pad
    ws = [f.shape[2] for f in features] + [0] * pad
    sts = [int(st) for st in strides[:n]] + [0] * pad
    lib = kernels.library()
    with torch.cuda.device(rois.device):
        rc = lib.pfr_multilevel_roi_align(
            *ptrs, *hs, *ws, *sts, n, C, kernels.ptr(rois), kernels.ptr(bidx),
            kernels.ptr(lvl), K, oh, ow, sampling_ratio, kernels.ptr(out),
            kernels.stream_of(rois))
    kernels.raise_on_error("multilevel_roi_align", rc)
    kernels.count_launch("multilevel_roi_align")
    return out
