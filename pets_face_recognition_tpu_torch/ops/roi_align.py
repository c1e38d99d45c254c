"""FPN multilevel RoIAlign (counterpart of the JAX ``ops/roi_align.py`` and of
``ops/pallas_roi_align.py::multilevel_roi_align_pallas``).

Layouts are the JAX package's: NHWC ``(B, H_l, W_l, C)`` levels, ``(K, 4)``
xyxy RoIs in image coordinates, ``(K, oh, ow, C)`` output. ``roi_levels`` plus
``multilevel_roi_align`` (one gather over the flattened pyramid) are the plain
PyTorch version of kernel K3; ``multilevel_roi_align_cuda`` is its wrapper,
which launches ``csrc/roi_align.cu`` for CUDA tensors and calls the plain
version for CPU tensors. ``multilevel_roi_align_backward`` (scatter-add of the
same taps) is the plain version of kernel K4, the gradient with respect to the
levels (counterpart of ``pallas_roi_align.py::_roi_backward``), and
``multilevel_roi_align_backward_cuda`` its wrapper over
``csrc/roi_align_backward.cu``, whose pre-pass (``roi_footprints_cuda``, plain
twin ``roi_levels`` then ``roi_footprints``) sorts the RoIs by level and image
and bounds the cells each can reach. The kernels map each RoI to its level
themselves, operation for operation as ``roi_levels`` does on the card, so a
wrapper is one allocation and one launch (K4: the pre-pass, a sort and the
launch). ``MultilevelRoIAlign`` ties the two into one
``torch.autograd.Function``. Numerics: torchvision ``aligned=False`` with a
fixed ``sampling_ratio``.

K3 and K4 each have a second instance for bfloat16 levels, which a detector
computing in bfloat16 hands them: the JAX kernels' ``compute_dtype=bfloat16``.
K3's rounds the interpolation weights to bfloat16 and sums in float32 (plain
version ``multilevel_roi_align_bf16``); K4's rounds the weights and each
sample's cotangent ``g / s^2`` to bfloat16 and sums in float32, the first of
its two contractions on the tensor cores (plain version
``multilevel_roi_align_backward_bf16``). The wrappers pick the instance from
the levels' dtype, so a float32 detector stays float32 throughout.

Output dtypes: K3's output is float32 by default, as JAX's; ``out_dtype`` may
instead be the levels' bfloat16, the float32 result rounded to nearest even,
which is what a caller whose next layer computes in bfloat16 would round it to
(``models/rcnn.py`` asks for it there: the box head's ``fc6``, the mask and
keypoint heads' first convolutions). K4's level gradients are in the levels'
dtype (the custom VJP's cast), written so by the kernel; ``out_dtype=float32``
returns the bfloat16 instance's float32 sums. K4 reads the cotangent as float32
or bfloat16, whichever it is given (a bfloat16 output's cotangent is
bfloat16).
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


def _taps(level_shapes, rois, roi_batch_idx, output_size, strides, s,
          canonical_scale, canonical_level, min_level, max_level, axis_weights=False):
    """Bilinear taps of every sample: 4 flat row indices into the ``(B * P, C)``
    concatenated pyramid and 4 weights, each ``(K, oh * s, ow * s)``, the
    out-of-bounds mask, and ``P`` (cells per image); with ``axis_weights``
    also the per-axis weights ``(hy, ly, hx, lx)`` (row low, row high, column
    low, column high) whose products the 4 weights are. Shared by the plain
    forwards and backward so that all use the same geometry."""
    oh, ow = output_size
    K = rois.shape[0]
    dev = rois.device
    sizes = [(sh[1], sh[2]) for sh in level_shapes]
    offsets, off = [], 0
    for h, w in sizes:
        offsets.append(off)
        off += h * w
    P = off
    hs = torch.tensor([h for h, _ in sizes], dtype=torch.int64, device=dev)
    ws = torch.tensor([w for _, w in sizes], dtype=torch.int64, device=dev)
    offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
    scales = torch.tensor([1.0 / st for st in strides[: len(sizes)]],
                          dtype=torch.float32, device=dev)

    rois = rois.float()
    lvl = roi_levels(rois, min_level, max_level, canonical_scale,
                     canonical_level).long()
    scale, H, W, base = scales[lvl], hs[lvl], ws[lvl], offs[lvl]

    boxes = rois * scale[:, None]
    x1, y1 = boxes[:, 0], boxes[:, 1]
    roi_w = (boxes[:, 2] - boxes[:, 0]).clamp(min=1.0)
    roi_h = (boxes[:, 3] - boxes[:, 1]).clamp(min=1.0)
    # divide by tensors: PyTorch's CUDA kernels turn a division by a Python
    # scalar into a product with its rounded reciprocal, which would move the
    # samples by an ulp against the kernels' correctly rounded division
    bin_h = roi_h / torch.full_like(roi_h, oh)
    bin_w = roi_w / torch.full_like(roi_w, ow)
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

    row0 = roi_batch_idx.long()[:, None, None] * P + base[:, None, None]
    idx = [row0 + yi * W3 + xi for yi, xi in
           ((y_low, x_low), (y_low, x_high), (y_high, x_low), (y_high, x_high))]
    wts = [hy * hx, hy * lx, ly * hx, ly * lx]
    if axis_weights:
        return idx, wts, oob, P, (hy, ly, hx, lx)
    return idx, wts, oob, P


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
    idx, wts, oob, P = _taps([f.shape for f in features], rois, roi_batch_idx,
                             output_size, strides, s, canonical_scale,
                             canonical_level, min_level, max_level)
    big = torch.cat([f.float().reshape(B, -1, C) for f in features], dim=1).reshape(B * P, C)

    def take(i):
        return big[i.reshape(-1)].reshape(K, oh * s, ow * s, C)

    val = (take(idx[0]) * wts[0][..., None] + take(idx[1]) * wts[1][..., None]
           + take(idx[2]) * wts[2][..., None] + take(idx[3]) * wts[3][..., None])
    val = torch.where(oob[..., None], torch.zeros((), device=rois.device), val)
    return val.reshape(K, oh, s, ow, s, C).mean(dim=(2, 4))


def multilevel_roi_align_bf16(features: list[torch.Tensor], rois: torch.Tensor,
                              roi_batch_idx: torch.Tensor, output_size: tuple[int, int],
                              strides: tuple[int, ...], sampling_ratio: int = 2,
                              canonical_scale: float = 224.0, canonical_level: int = 4,
                              min_level: int = 2, max_level: int = 5,
                              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain K3 over bfloat16 levels, the JAX kernel's ``compute_dtype=bfloat16``:
    the taps and samples of :func:`multilevel_roi_align`, the row and column
    weights rounded to bfloat16, each column's two rows summed first and then
    the two columns, in float32. Returns ``(K, oh, ow, C)`` in float32, or
    rounded to ``out_dtype``."""
    oh, ow = output_size
    s = sampling_ratio
    B, _, _, C = features[0].shape
    K = rois.shape[0]
    idx, _, oob, P, axis_w = _taps([f.shape for f in features], rois, roi_batch_idx,
                                   output_size, strides, s, canonical_scale,
                                   canonical_level, min_level, max_level, axis_weights=True)
    wy_lo, wy_hi, wx_lo, wx_hi = (w.to(torch.bfloat16).float()[..., None] for w in axis_w)
    big = torch.cat([f.to(torch.bfloat16).float().reshape(B, -1, C) for f in features],
                    dim=1).reshape(B * P, C)

    def take(i):
        return big[i.reshape(-1)].reshape(K, oh * s, ow * s, C)

    col_lo = take(idx[0]) * wy_lo + take(idx[2]) * wy_hi
    col_hi = take(idx[1]) * wy_lo + take(idx[3]) * wy_hi
    val = col_lo * wx_lo + col_hi * wx_hi
    val = torch.where(oob[..., None], torch.zeros((), device=rois.device), val)
    return val.reshape(K, oh, s, ow, s, C).mean(dim=(2, 4)).to(out_dtype)


def multilevel_roi_align_backward(grad_out: torch.Tensor,
                                  level_shapes: list[tuple[int, int, int, int]],
                                  rois: torch.Tensor, roi_batch_idx: torch.Tensor,
                                  output_size: tuple[int, int], strides: tuple[int, ...],
                                  sampling_ratio: int = 2, canonical_scale: float = 224.0,
                                  canonical_level: int = 4, min_level: int = 2,
                                  max_level: int = 5) -> list[torch.Tensor]:
    """Plain K4: the gradient of :func:`multilevel_roi_align` with respect to
    each NHWC level, for the output cotangent ``grad_out (K, oh, ow, C)``.

    Rebuilds the forward's taps (same levels, clamps, edge rule and ``oob``
    mask), spreads ``g / s^2`` over the ``s x s`` samples of each cell and
    scatter-adds the four weighted taps per sample into zeroed levels with
    ``index_add_``. Returns float32 levels of ``level_shapes``.
    """
    return _backward(grad_out, level_shapes, rois, roi_batch_idx, output_size, strides,
                     sampling_ratio, canonical_scale, canonical_level, min_level, max_level,
                     bf16=False)


def multilevel_roi_align_backward_bf16(grad_out: torch.Tensor,
                                       level_shapes: list[tuple[int, int, int, int]],
                                       rois: torch.Tensor, roi_batch_idx: torch.Tensor,
                                       output_size: tuple[int, int], strides: tuple[int, ...],
                                       sampling_ratio: int = 2, canonical_scale: float = 224.0,
                                       canonical_level: int = 4, min_level: int = 2,
                                       max_level: int = 5) -> list[torch.Tensor]:
    """Plain K4 with bfloat16 operands, the JAX backward's default
    ``compute_dtype=bfloat16`` (``pallas_roi_align.py:399-403``): each
    sample's cotangent ``g / s^2`` and its row and column weights rounded to
    bfloat16, the products and sums in float32. Returns float32 levels of
    ``level_shapes``: the sums that the kernel rounds to the levels' dtype
    as it writes them."""
    return _backward(grad_out, level_shapes, rois, roi_batch_idx, output_size, strides,
                     sampling_ratio, canonical_scale, canonical_level, min_level, max_level,
                     bf16=True)


def _backward(grad_out, level_shapes, rois, roi_batch_idx, output_size, strides,
              sampling_ratio, canonical_scale, canonical_level, min_level, max_level,
              bf16: bool) -> list[torch.Tensor]:
    oh, ow = output_size
    s = sampling_ratio
    K, _, _, C = grad_out.shape
    B = level_shapes[0][0]
    idx, wts, oob, P, axis_w = _taps(level_shapes, rois, roi_batch_idx, output_size, strides,
                                     s, canonical_scale, canonical_level, min_level, max_level,
                                     axis_weights=True)
    g = grad_out.float() / (s * s)
    if bf16:
        hy, ly, hx, lx = (w.to(torch.bfloat16).float() for w in axis_w)
        wts = [hy * hx, hy * lx, ly * hx, ly * lx]
        g = g.to(torch.bfloat16).float()
    gs = g[:, :, None, :, None, :].expand(K, oh, s, ow, s, C).reshape(K, oh * s, ow * s, C)
    gs = torch.where(oob[..., None], torch.zeros((), device=gs.device), gs)
    # one buffer per tap, summed last tap first: the order in which autograd
    # through the plain forward accumulates, so the two agree to the bit
    flat = None
    for i, w in reversed(list(zip(idx, wts))):
        tap = torch.zeros(B * P, C, dtype=torch.float32, device=grad_out.device)
        tap.index_add_(0, i.reshape(-1), (gs * w[..., None]).reshape(-1, C))
        flat = tap if flat is None else flat + tap
    flat = flat.reshape(B, P, C)
    grads, off = [], 0
    for sh in level_shapes:
        n = sh[1] * sh[2]
        grads.append(flat[:, off:off + n].reshape(B, sh[1], sh[2], C))
        off += n
    return grads


def roi_footprints(level_shapes: list[tuple[int, int, int, int]], rois: torch.Tensor,
                   lvl: torch.Tensor, output_size: tuple[int, int],
                   strides: tuple[int, ...], sampling_ratio: int = 2) -> torch.Tensor:
    """K4's pre-pass: the footprint of each RoI on its level ``lvl`` (from
    :func:`roi_levels`), ``(K, 4)`` int32 ``(y_lo, y_hi, x_lo, x_hi)``, inclusive.

    It holds every row and column that a tap of the RoI with a nonzero weight
    can reach (the clamped high neighbour included), with one more on each
    side so that rounding in the sample positions cannot leave one out, clipped
    to the level. ``y_hi = -1`` where no sample can be in bounds. Plain tensor
    ops: the same code runs on the CPU and on the card.
    """
    dev = rois.device
    oh, ow = output_size
    li = lvl.long()
    # (W, H) and 1 / stride of each RoI's level, x before y like the RoI
    lim = torch.tensor([[sh[2], sh[1]] for sh in level_shapes], dtype=torch.float32,
                       device=dev)[li]
    scale = torch.tensor([1.0 / st for st in strides[:len(level_shapes)]],
                         dtype=torch.float32, device=dev)[li]
    r = rois.float() * scale[:, None]
    n = torch.tensor([ow, oh], dtype=torch.float32, device=dev)
    bins = (r[:, 2:] - r[:, :2]).clamp(min=1.0) / n
    # first and last sample of each axis: i + (p + .5) / s for i = 0, p = 0 and
    # for i = n - 1, p = s - 1; taps reach floor(pos) and the row after it
    lo = torch.floor(r[:, :2] + bins * (0.5 / sampling_ratio)) - 1
    hi = torch.floor(r[:, :2] + bins * (n - 0.5 / sampling_ratio)) + 2
    empty = ((hi < 0) | (lo > lim - 1)).any(dim=1, keepdim=True)
    lo = torch.minimum(lo.clamp(min=0), lim - 1)
    hi = torch.where(empty, torch.full_like(hi, -1), torch.minimum(hi.clamp(min=0), lim - 1))
    return torch.stack([lo[:, 1], hi[:, 1], lo[:, 0], hi[:, 0]], dim=1).to(torch.int32)


def roi_footprints_cuda(level_shapes: list[tuple[int, int, int, int]], rois: torch.Tensor,
                        roi_batch_idx: torch.Tensor, output_size: tuple[int, int],
                        strides: tuple[int, ...], sampling_ratio: int = 2,
                        canonical_scale: float = 224.0, canonical_level: int = 4,
                        min_level: int = 2, max_level: int = 5,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's pre-pass in one launch: ``(key (K,) int32, footprint (K, 4) int32)``,
    where ``key`` is ``level * B + image`` with the level of :func:`roi_levels`
    (``n_levels * B`` for an image index outside ``[0, B)``) and ``footprint``
    is :func:`roi_footprints`; the kernel repeats both operation for
    operation. Plain torch ops for CPU tensors.
    """
    B, n_levels = level_shapes[0][0], len(level_shapes)
    if rois.device.type == "cpu":
        lvl = roi_levels(rois, min_level, max_level, canonical_scale, canonical_level)
        b = roi_batch_idx.long()
        key = torch.where((b >= 0) & (b < B), lvl.long() * B + b,
                          torch.full_like(b, n_levels * B)).to(torch.int32)
        return key, roi_footprints(level_shapes, rois, lvl, output_size, strides,
                                   sampling_ratio)
    hs, ws, sts = _level_args(level_shapes, strides, min_level, max_level)
    _check_rois(rois, roi_batch_idx)
    K = rois.shape[0]
    bidx = roi_batch_idx.to(torch.int32).contiguous()
    key = torch.empty(K, dtype=torch.int32, device=rois.device)
    footprint = torch.empty((K, 4), dtype=torch.int32, device=rois.device)
    if K:
        kernels.launch("roi_footprints", "pfr_roi_footprints", rois.device, rois.data_ptr(),
                       bidx.data_ptr(), *hs, *ws, *sts, n_levels, B, K,
                       *output_size, sampling_ratio, canonical_scale, canonical_level,
                       min_level, key.data_ptr(), footprint.data_ptr())
    return key, footprint


def _level_args(level_shapes, strides, min_level, max_level):
    """Per-level ``H``, ``W`` and stride, padded to the kernels' 4 levels."""
    n = len(level_shapes)
    if not 1 <= n <= 4 or len(strides) < n or max_level - min_level + 1 != n:
        raise ValueError(f"roi_align: 1-4 levels spanning min..max_level, got {n}")
    pad = 4 - n
    return ([sh[1] for sh in level_shapes] + [0] * pad,
            [sh[2] for sh in level_shapes] + [0] * pad,
            [int(st) for st in strides[:n]] + [0] * pad)


def _check_rois(rois: torch.Tensor, roi_batch_idx: torch.Tensor) -> None:
    kernels.check_cuda_f32("roi_align rois", rois, 2)
    if rois.shape[1] != 4:
        raise ValueError(f"roi_align rois: expected (K, 4), got {tuple(rois.shape)}")
    if roi_batch_idx.shape != (rois.shape[0],) or roi_batch_idx.device != rois.device:
        raise ValueError("roi_align batch index: expected (K,) on the rois' device")


def multilevel_roi_align_cuda(features: list[torch.Tensor], rois: torch.Tensor,
                              roi_batch_idx: torch.Tensor,
                              output_size: tuple[int, int], strides: tuple[int, ...],
                              sampling_ratio: int = 2, canonical_scale: float = 224.0,
                              canonical_level: int = 4, min_level: int = 2,
                              max_level: int = 5,
                              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K3 wrapper: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

    Same arguments and result as :func:`multilevel_roi_align`; at most 4 levels,
    ``C`` a multiple of the channels of one 16-byte load (4 float32, 8
    bfloat16) and levels aligned to 16 bytes. The kernel maps each RoI to its
    level as :func:`roi_levels` does, so the result is bit-equal to the plain
    version's.
    bfloat16 levels (all of them) take the bfloat16 instance, whose plain
    version is :func:`multilevel_roi_align_bf16`; the result is float32, or
    for bfloat16 levels ``out_dtype=torch.bfloat16``, the float32 result
    rounded to nearest even. Not differentiable: :class:`MultilevelRoIAlign`
    is.
    """
    f0 = features[0]
    bf16 = f0.dtype == torch.bfloat16
    if out_dtype not in (torch.float32, f0.dtype):
        raise ValueError(f"roi_align: output float32 or the levels' {f0.dtype}, got {out_dtype}")
    if rois.device.type == "cpu":
        args = (features, rois, roi_batch_idx, output_size, strides, sampling_ratio,
                canonical_scale, canonical_level, min_level, max_level)
        if bf16:
            return multilevel_roi_align_bf16(*args, out_dtype=out_dtype)
        return multilevel_roi_align(*args)
    hs, ws, sts = _level_args([f.shape for f in features], strides, min_level, max_level)
    B, _, _, C = f0.shape
    vec = 8 if bf16 else 4
    for i, f in enumerate(features):
        # every level float32, or every level bfloat16 (the first's dtype)
        if bf16:
            kernels.check_cuda(f"roi_align level {i}", f, 4, (torch.bfloat16,))
        else:
            kernels.check_cuda_f32(f"roi_align level {i}", f, 4)
        if f.shape[0] != B or f.shape[3] != C or f.device != rois.device:
            raise ValueError("roi_align: levels must share B, C and the device")
        if C % vec or f.data_ptr() % 16:
            raise ValueError(f"roi_align: the kernel reads {vec} channels at once; needs "
                             f"C % {vec} == 0 (C % 4 for float32, % 8 for bfloat16) and "
                             f"levels aligned to 16 bytes (C = {C})")
    _check_rois(rois, roi_batch_idx)
    K = rois.shape[0]
    oh, ow = output_size
    out = torch.empty((K, oh, ow, C), dtype=out_dtype, device=rois.device)
    if K == 0:
        return out
    bidx = roi_batch_idx.to(torch.int32).contiguous()  # no copy when it is one
    ptrs = [f.data_ptr() for f in features] + [None] * (4 - len(features))
    tail = (out.data_ptr(), int(out_dtype == torch.bfloat16)) if bf16 else (out.data_ptr(),)
    name = "multilevel_roi_align_bf16" if bf16 else "multilevel_roi_align"
    kernels.launch(name, f"pfr_{name}", rois.device,
                   *ptrs, *hs, *ws, *sts, len(features), C, rois.data_ptr(),
                   bidx.data_ptr(), K, oh, ow, sampling_ratio,
                   canonical_scale, canonical_level, min_level, *tail)
    return out


def multilevel_roi_align_backward_cuda(grad_out: torch.Tensor,
                                       level_shapes: list[tuple[int, int, int, int]],
                                       rois: torch.Tensor, roi_batch_idx: torch.Tensor,
                                       output_size: tuple[int, int],
                                       strides: tuple[int, ...], sampling_ratio: int = 2,
                                       canonical_scale: float = 224.0,
                                       canonical_level: int = 4, min_level: int = 2,
                                       max_level: int = 5,
                                       dtype: torch.dtype = torch.float32,
                                       out_dtype: torch.dtype | None = None
                                       ) -> list[torch.Tensor]:
    """K4 wrapper: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

    Same arguments and result as :func:`multilevel_roi_align_backward`; at most
    4 levels and 32 x 32 output cells. ``dtype`` is the levels' type:
    ``torch.bfloat16`` takes the bfloat16 instance (plain version
    :func:`multilevel_roi_align_backward_bf16`; ``C`` a multiple of 8 and at
    most 64 sample rows), which reads a float32 or bfloat16 cotangent and writes
    its float32 sums rounded to ``out_dtype`` (by default ``dtype``;
    ``torch.float32`` returns the sums themselves). The RoIs are sorted by
    (level, image), stably, and given their :func:`roi_footprints`; the kernel
    writes every element of the level gradients once, summing in a fixed
    order, so its result is the same to the bit from launch to launch. It
    agrees with the plain version to float32 rounding of a short sum. A RoI
    whose batch index is outside ``[0, B)`` adds nothing.
    """
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"roi_align_backward: levels float32 or bfloat16, got {dtype}")
    bf16 = dtype == torch.bfloat16
    out_dtype = out_dtype or dtype
    if grad_out.device.type == "cpu":
        plain = multilevel_roi_align_backward_bf16 if bf16 else multilevel_roi_align_backward
        grads = plain(grad_out, level_shapes, rois, roi_batch_idx, output_size, strides,
                      sampling_ratio, canonical_scale, canonical_level, min_level, max_level)
        return [d.to(out_dtype) for d in grads]
    hs, ws, sts = _level_args(level_shapes, strides, min_level, max_level)
    kernels.check_cuda("roi_align_backward grad", grad_out, 4,
                       (torch.float32, torch.bfloat16) if bf16 else (torch.float32,))
    _check_rois(rois, roi_batch_idx)
    K, oh, ow, C = grad_out.shape
    if K != rois.shape[0] or (oh, ow) != tuple(output_size) or grad_out.device != rois.device:
        raise ValueError("roi_align_backward: grad must be (K, oh, ow, C) on the rois' device")
    B = level_shapes[0][0]
    if any(sh[0] != B or sh[3] != C for sh in level_shapes):
        raise ValueError("roi_align_backward: levels must share B and the grad's C")
    if max(oh, ow) > 32:
        raise ValueError(f"roi_align_backward: at most 32 x 32 output cells, got {oh} x {ow}")
    if bf16 and (C % 8 or oh * sampling_ratio > 64 or
                 out_dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError("roi_align_backward bfloat16: needs C % 8 == 0, at most 64 sample "
                         f"rows and float32 or bfloat16 gradients (C = {C}, "
                         f"{oh * sampling_ratio} rows, {out_dtype})")
    dev = rois.device
    written = out_dtype if bf16 else torch.float32
    grads = [torch.empty(tuple(sh), dtype=written, device=dev) for sh in level_shapes]
    key, footprint = roi_footprints_cuda(level_shapes, rois, roi_batch_idx, output_size,
                                         strides, sampling_ratio, canonical_scale,
                                         canonical_level, min_level, max_level)
    key, order = torch.sort(key, stable=True)
    group_start = torch.searchsorted(
        key, torch.arange(len(level_shapes) * B + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    ptrs = [d.data_ptr() for d in grads] + [None] * (4 - len(grads))
    tail = (len(grads), B, C, rois.data_ptr(), order.data_ptr(), footprint.data_ptr(),
            group_start.data_ptr(), oh, ow, sampling_ratio)
    if bf16:
        kernels.launch("multilevel_roi_align_backward_bf16",
                       "pfr_multilevel_roi_align_backward_bf16", dev, grad_out.data_ptr(),
                       int(grad_out.dtype == torch.bfloat16), *ptrs,
                       int(written == torch.bfloat16), *hs, *ws, *sts, *tail)
        return grads
    kernels.launch("multilevel_roi_align_backward", "pfr_multilevel_roi_align_backward", dev,
                   grad_out.data_ptr(), *ptrs, *hs, *ws, *sts, *tail)
    return [d.to(out_dtype) for d in grads]


class MultilevelRoIAlign(torch.autograd.Function):
    """Differentiable multilevel RoIAlign: forward K3, backward K4 (their
    plain versions for CPU tensors), each in the instance of the levels'
    dtype. The output is ``out_dtype`` (float32, or the levels' bfloat16);
    gradients reach the levels only, in the levels' dtype; the RoIs and batch
    indices get none, as in the JAX custom VJP and torchvision.

    ``apply(rois, roi_batch_idx, output_size, strides, sampling_ratio,
    canonical_scale, canonical_level, min_level, max_level, out_dtype,
    *features)``.
    """

    @staticmethod
    def forward(ctx, rois, roi_batch_idx, output_size, strides, sampling_ratio,
                canonical_scale, canonical_level, min_level, max_level, out_dtype, *features):
        args = (output_size, strides, sampling_ratio, canonical_scale,
                canonical_level, min_level, max_level)
        ctx.save_for_backward(rois, roi_batch_idx)
        ctx.args = args
        ctx.level_shapes = [tuple(f.shape) for f in features]
        ctx.dtype = features[0].dtype
        return multilevel_roi_align_cuda(list(features), rois, roi_batch_idx, *args,
                                         out_dtype=out_dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        rois, roi_batch_idx = ctx.saved_tensors
        # K4-bf16 reads a bfloat16 cotangent as it comes; float32 K4 takes float32
        if not (ctx.dtype == torch.bfloat16 and grad_out.dtype == torch.bfloat16):
            grad_out = grad_out.float()
        grads = multilevel_roi_align_backward_cuda(
            grad_out.contiguous(), ctx.level_shapes, rois, roi_batch_idx, *ctx.args,
            dtype=ctx.dtype)
        return (None,) * 10 + tuple(grads)


def multilevel_roi_align_diff(features: list[torch.Tensor], rois: torch.Tensor,
                              roi_batch_idx: torch.Tensor,
                              output_size: tuple[int, int], strides: tuple[int, ...],
                              sampling_ratio: int = 2, canonical_scale: float = 224.0,
                              canonical_level: int = 4, min_level: int = 2,
                              max_level: int = 5,
                              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:class:`MultilevelRoIAlign` with the arguments of :func:`multilevel_roi_align`
    and ``out_dtype`` (float32, or the levels' bfloat16)."""
    return MultilevelRoIAlign.apply(rois, roi_batch_idx, tuple(output_size),
                                    tuple(strides), sampling_ratio, canonical_scale,
                                    canonical_level, min_level, max_level, out_dtype,
                                    *features)
