"""Homography solve and projective warp (counterpart of the JAX ``ops/homography.py``
and of ``ops/pallas_warp.py::warp_affine_batch_pallas``).

Images are NHWC; landmarks are ``(B, 3, 2)`` as ``(x, y)``. ``warp_perspective``
(one image) and ``warp_perspective_batch`` are the plain PyTorch version of
kernel K1 (with :func:`invert_homographies`, the closed-form inverse the
kernel repeats); ``warp_perspective_batch_cuda`` is its wrapper, which launches
``csrc/warp.cu`` for CUDA tensors and calls the plain version for CPU tensors.
``align_crop`` is the reference ``align()``: centroid-augmented 4-point
homography, then the projective warp.

K1 has the JAX kernel's three compute modes (``compute_dtype``, one of
:data:`WARP_DTYPES`): float32, the exact op; bfloat16, pixels and x-tent
weights rounded to bfloat16 with float32 sums; int8, pixels and x-tent
weights quantized at scale 127 with an exact integer row sum (see
``csrc/warp.cu``). ``out_dtype`` bfloat16 rounds the float32 result once.
The int8 instance stages each tile's box of source pixels in shared memory;
:func:`warp_tile_boxes` is its per-tile rule, and :func:`warp_tap_sources`
counts where it reads each tap.
"""

from __future__ import annotations

import math

import torch

from .. import kernels


def solve_homography(src_pts: torch.Tensor, dst_pts: torch.Tensor) -> torch.Tensor:
    """``H`` with ``dst ~ H @ src`` and ``h33 = 1``, float32, ``(..., 3, 3)``.

    ``(..., N, 2)`` points, ``N >= 4``: ``N == 4`` is the exact solve, more points
    solve the DLT normal equations. Hartley-normalised, as in the JAX package.
    """
    src = src_pts.float()
    dst = dst_pts.float()
    n = src.shape[-2]

    def norm_transform(pts):
        mean = pts.mean(dim=-2, keepdim=True)
        rms = torch.sqrt(((pts - mean) ** 2).sum(-1).mean(-1, keepdim=True))
        scale = math.sqrt(2.0) / rms.clamp(min=1e-8)
        return (pts - mean) * scale[..., None], mean[..., 0, :], scale

    src, src_mean, src_scale = norm_transform(src)
    dst, dst_mean, dst_scale = norm_transform(dst)
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    row_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], dim=-1)
    row_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], dim=-1)
    A = torch.cat([row_u, row_v], dim=-2)
    b = torch.cat([u, v], dim=-1)[..., None]
    if n == 4:
        h = torch.linalg.solve_ex(A, b).result[..., 0]
    else:
        At = A.transpose(-1, -2)
        h = torch.linalg.solve_ex(At @ A, At @ b).result[..., 0]
    Hn = torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(*h.shape[:-1], 3, 3)

    def T(mean, scale, inverse):
        s = scale[..., 0]
        z, o = torch.zeros_like(s), torch.ones_like(s)
        if inverse:
            inv = 1.0 / s
            rows = [[inv, z, mean[..., 0]], [z, inv, mean[..., 1]], [z, z, o]]
        else:
            rows = [[s, z, -s * mean[..., 0]], [z, s, -s * mean[..., 1]], [z, z, o]]
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    H = T(dst_mean, dst_scale, True) @ Hn @ T(src_mean, src_scale, False)
    return H / H[..., 2:3, 2:3]


WARP_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
# the int8 mode's dequantization, 1 / 127^2 rounded to float32 (as JAX's
# Python constant meets a float32 array)
INV_127_SQ = 1.0 / (127.0 * 127.0)
# kernel K1's launch-count name and symbol for each compute mode
_K1 = {torch.float32: ("warp_perspective_batch", "pfr_warp_perspective_batch"),
       torch.bfloat16: ("warp_perspective_batch_bf16", "pfr_warp_perspective_batch_bf16"),
       torch.int8: ("warp_perspective_batch_int8", "pfr_warp_perspective_batch_int8")}
# K1's int8 instance (csrc/warp.cu, whose kTileH, kTileW, kPx, kStagePixels
# and kBoxSlack these repeat; a test holds them equal): a block owns a tile of
# K1_TILE = (rows, columns) crop pixels, K1_PX adjacent pixels a thread, and
# stages the tile's box of source pixels in shared memory where the box spans
# at most K1_STAGE_PIXELS pixels (its rows times their pitch); the box is the
# corners' taps widened by K1_BOX_SLACK pixels on every side.
K1_TILE = (16, 32)
K1_PX = 4
K1_STAGE_PIXELS = 3072
K1_BOX_SLACK = 1


def _check_warp_dtypes(compute_dtype: torch.dtype, out_dtype: torch.dtype) -> None:
    if compute_dtype not in WARP_DTYPES:
        raise ValueError(f"warp compute_dtype {compute_dtype}: expected one of {WARP_DTYPES}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"warp out_dtype {out_dtype}: expected float32 or bfloat16")


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _bilinear_sample(images: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32):
    """Sample NHWC ``images`` at float coords ``sx, sy (B, oh, ow)``; zero outside.

    ``compute_dtype`` float32 weighs the four taps by the bilinear products;
    bfloat16 and int8 round each tap and each x-tent weight (``1 - fx``,
    ``fx``) as K1's modes do, sum a source row's two products in float32 and
    weigh the two row sums by the float32 y-tent (``1 - fy``, ``fy``)."""
    B, H, W, C = images.shape
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    flat = images.reshape(B * H * W, C)
    bofs = (torch.arange(B, device=images.device) * (H * W))[:, None, None]
    zero = torch.zeros((), device=images.device)

    def tap(yy, xx):
        # bounds on the float coordinates (false for NaN, as from a degenerate
        # map), then index 0 where out of bounds, as K1 does
        inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        yi = torch.where(inb, yy, 0.0).long()
        xi = torch.where(inb, xx, 0.0).long()
        vals = flat[(bofs + yi * W + xi).reshape(-1)].reshape(*yy.shape, C)
        return torch.where(inb[..., None], vals, zero)

    if compute_dtype == torch.float32:
        w00 = ((1 - fy) * (1 - fx))[..., None]
        w01 = ((1 - fy) * fx)[..., None]
        w10 = (fy * (1 - fx))[..., None]
        w11 = (fy * fx)[..., None]
        return (tap(y0, x0) * w00 + tap(y0, x0 + 1) * w01
                + tap(y0 + 1, x0) * w10 + tap(y0 + 1, x0 + 1) * w11)
    gfx, gfy = 1 - fx, 1 - fy
    if compute_dtype == torch.bfloat16:
        wx0, wx1 = _round_bf16(gfx)[..., None], _round_bf16(fx)[..., None]

        def row(a, b):
            return _round_bf16(a) * wx0 + _round_bf16(b) * wx1
    else:
        # int8: the products and their sum are integers below 2^15, exact
        wx0, wx1 = torch.round(gfx * 127.0)[..., None], torch.round(fx * 127.0)[..., None]
        inv = torch.full((), INV_127_SQ, device=images.device)

        def q(p):
            return torch.round(p * 127.0).clamp(0.0, 127.0)

        def row(a, b):
            return (q(a) * wx0 + q(b) * wx1) * inv
    return (row(tap(y0, x0), tap(y0, x0 + 1)) * gfy[..., None]
            + row(tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)) * fy[..., None])


def invert_homographies(Hs: torch.Tensor) -> torch.Tensor:
    """Closed-form float32 inverse of each ``(B, 3, 3)`` matrix: adjugate over
    determinant, in the K1 kernel's order of operations (each product, sum and
    quotient rounded on its own; division by tensors, which PyTorch's CUDA
    kernels round correctly, not by Python scalars)."""
    a, b, c, d, e, f, g, h, i = Hs.float().reshape(-1, 9).unbind(-1)
    adj = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                       f * g - d * i, a * i - c * g, c * d - a * f,
                       d * h - e * g, b * g - a * h, a * e - b * d], dim=-1)
    det = a * adj[:, 0] + b * adj[:, 3] + c * adj[:, 6]
    return (adj / det[:, None]).reshape(-1, 3, 3)


def _sample_coords(Hinv: torch.Tensor, dsize: tuple[int, int]):
    """Source coords ``(sx, sy)``, each ``(B, oh, ow)``, of the output grid."""
    out_h, out_w = dsize
    dev = Hinv.device
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev),
                            indexing="ij")
    h = Hinv[:, :, :, None, None]
    denom = h[:, 2, 0] * gx + h[:, 2, 1] * gy + h[:, 2, 2]
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    sx = (h[:, 0, 0] * gx + h[:, 0, 1] * gy + h[:, 0, 2]) / denom
    sy = (h[:, 1, 0] * gx + h[:, 1, 1] * gy + h[:, 1, 2]) / denom
    return sx, sy


def warp_perspective_batch(images: torch.Tensor, Hs: torch.Tensor,
                           dsize: tuple[int, int], compute_dtype: torch.dtype = torch.float32,
                           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain K1: ``(B, H, W, C) x (B, 3, 3) -> (B, out_h, out_w, C)`` of ``out_dtype``.

    cv2 ``warpPerspective`` semantics: output pixel ``(x, y)`` bilinearly samples
    the source at ``H^-1 @ (x, y, 1)``, zero outside the image; ``H^-1`` from
    :func:`invert_homographies`. ``compute_dtype`` (:data:`WARP_DTYPES`) picks
    the mode (see :func:`_bilinear_sample`); ``out_dtype`` bfloat16 rounds the
    float32 result once.
    """
    _check_warp_dtypes(compute_dtype, out_dtype)
    sx, sy = _sample_coords(invert_homographies(Hs), dsize)
    return _bilinear_sample(images.float(), sx, sy, compute_dtype).to(out_dtype)


def warp_perspective(image: torch.Tensor, H: torch.Tensor,
                     dsize: tuple[int, int]) -> torch.Tensor:
    """One ``(H, W, C)`` image: :func:`warp_perspective_batch` of a batch of one."""
    return warp_perspective_batch(image[None], H[None], dsize)[0]


def warp_perspective_batch_cuda(images: torch.Tensor, Hs: torch.Tensor,
                                dsize: tuple[int, int], compute_dtype: torch.dtype = torch.float32,
                                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

    One launch: the kernel inverts each ``H`` itself, as :func:`invert_homographies`
    does. Takes contiguous float32 ``(B, H, W, C<=4)`` images and ``(B, 3, 3)``
    maps on the same device; ``compute_dtype`` and ``out_dtype`` as for
    :func:`warp_perspective_batch`, each mode its own kernel instance (counted
    as ``warp_perspective_batch``, ``_bf16`` or ``_int8``).
    """
    _check_warp_dtypes(compute_dtype, out_dtype)
    if images.device.type == "cpu":
        return warp_perspective_batch(images, Hs, dsize, compute_dtype, out_dtype)
    kernels.check_cuda_f32("warp images", images, 4)
    kernels.check_cuda_f32("warp maps", Hs, 3)
    B, H, W, C = images.shape
    if C > 4 or Hs.shape != (B, 3, 3) or Hs.device != images.device:
        raise ValueError(f"warp: expected (B,H,W,C<=4) images and (B,3,3) H, got "
                         f"{tuple(images.shape)} and {tuple(Hs.shape)}")
    out_h, out_w = dsize
    out = images.new_empty((B, out_h, out_w, C), dtype=out_dtype)
    if out.numel() == 0:
        return out
    name, symbol = _K1[compute_dtype]
    kernels.launch(name, symbol, images.device, images.data_ptr(), Hs.data_ptr(),
                   out.data_ptr(), B, H, W, C, out_h, out_w, int(out_dtype == torch.bfloat16))
    return out


def warp_tile_boxes(Hs: torch.Tensor, dsize: tuple[int, int], image_hw: tuple[int, int],
                    box_slack: int = K1_BOX_SLACK) -> dict[str, torch.Tensor]:
    """Plain counterpart of the tile boxes of K1's int8 instance, for
    ``(B, 3, 3)`` maps and an ``(out_h, out_w)`` crop of ``(H, W)`` images.

    Each ``K1_TILE`` tile of a crop evaluates its four corner pixels (the last
    real pixel at a ragged edge) as the pixels do. It is ``safe`` where the
    corners' denominators share one sign and every corner's position is
    finite. Its box is the corners' taps widened by ``box_slack`` pixels and
    clipped to the image and a ring of one pixel around it (staged as 0),
    with columns widened to a multiple of 4 pixels from a multiple of 4; rows
    are padded to an odd count of 4-pixel groups. The tile is ``staged``
    where it is safe, the box is not empty, and its rows times their pitch
    fit in ``K1_STAGE_PIXELS``. A ``box_slack`` other than ``K1_BOX_SLACK``
    models what the kernel's test hook ``pfr_warp_int8_test_box_slack`` sets.
    Returns ``safe``, ``inside`` (the box is not empty) and ``staged`` of
    shape ``(B, tiles_y, tiles_x)`` and ``box``, ``(B, tiles_y, tiles_x, 4)``
    as ``(x, y, w, h)`` of the staged region (zeros where nothing is staged).
    """
    th, tw = K1_TILE
    out_h, out_w = dsize
    H, W = image_hw
    B = Hs.shape[0]
    m = invert_homographies(Hs.cpu()).reshape(B, 9, 1, 1, 1)
    ty = torch.arange(0, out_h, th)
    tx = torch.arange(0, out_w, tw)
    ys = torch.stack([ty, (ty + th).clamp(max=out_h) - 1], -1).float()   # (tiles_y, 2)
    xs = torch.stack([tx, (tx + tw).clamp(max=out_w) - 1], -1).float()   # (tiles_x, 2)
    gy = ys[:, None, :, None].expand(-1, len(tx), 2, 2).reshape(len(ty), len(tx), 4)
    gx = xs[None, :, None, :].expand(len(ty), -1, 2, 2).reshape(len(ty), len(tx), 4)
    den = m[:, 6] * gx + m[:, 7] * gy + m[:, 8]
    d = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    sx = (m[:, 0] * gx + m[:, 1] * gy + m[:, 2]) / d
    sy = (m[:, 3] * gx + m[:, 4] * gy + m[:, 5]) / d
    fin = sx.isfinite() & sy.isfinite()
    safe = (fin & (den > 0)).all(-1) | (fin & (den < 0)).all(-1)
    zero = torch.zeros(())
    sx, sy = torch.where(fin, sx, zero), torch.where(fin, sy, zero)
    xl = (sx.amin(-1).floor() - box_slack).clamp(min=-1.0)
    xh = (sx.amax(-1).floor() + 1.0 + box_slack).clamp(max=float(W))
    yl = (sy.amin(-1).floor() - box_slack).clamp(min=-1.0)
    yh = (sy.amax(-1).floor() + 1.0 + box_slack).clamp(max=float(H))
    inside = (xl <= xh) & (yl <= yh)
    xl, xh = xl.clamp(max=W + 1).long(), xh.clamp(min=-2).long()
    yl, yh = yl.clamp(max=H + 1).long(), yh.clamp(min=-2).long()
    x0 = xl & ~3
    w = (xh - x0 + 4) & ~3
    pitch = ((w // 4) | 1) * 4
    h = yh - yl + 1
    staged = safe & inside & (h * pitch <= K1_STAGE_PIXELS)
    box = torch.stack([x0, yl, w, h], -1) * staged[..., None]
    return {"safe": safe, "inside": inside, "staged": staged, "box": box}


def warp_tap_sources(Hs: torch.Tensor, dsize: tuple[int, int], image_hw: tuple[int, int],
                     box_slack: int = K1_BOX_SLACK) -> dict[str, int]:
    """Where K1's int8 instance reads the in-image taps on these maps
    (:func:`warp_tile_boxes`). A pixel of a staged tile whose four taps lie in
    the box reads them from shared memory (``staged_taps``); any other pixel
    reads its taps from global memory, in a staged tile
    (``box_miss_taps``) or in a tile that stages nothing
    (``tile_global_taps``). Also the tiles by branch: ``staged_tiles``,
    ``unsafe_tiles`` (sign or finiteness), ``budget_tiles`` (safe, with a box
    larger than the budget) and ``outside_tiles`` (safe, with no box)."""
    t = warp_tile_boxes(Hs, dsize, image_hw, box_slack)
    H, W = image_hw
    th, tw = K1_TILE
    sx, sy = _sample_coords(invert_homographies(Hs.cpu()), dsize)
    x0, y0 = sx.floor(), sy.floor()
    rows = torch.arange(dsize[0]) // th
    cols = torch.arange(dsize[1]) // tw
    tile_staged = t["staged"][:, rows][:, :, cols]        # (B, out_h, out_w)
    bx, by, bw, bh = t["box"][:, rows][:, :, cols].float().unbind(-1)
    staged = (tile_staged & (x0 >= bx) & (x0 + 1 < bx + bw) & (y0 >= by)
              & (y0 + 1 < by + bh))
    counts = dict.fromkeys(("staged_taps", "box_miss_taps", "tile_global_taps"), 0)
    for yy in (y0, y0 + 1):
        for xx in (x0, x0 + 1):
            inimg = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            counts["staged_taps"] += int((inimg & staged).sum())
            counts["box_miss_taps"] += int((inimg & tile_staged & ~staged).sum())
            counts["tile_global_taps"] += int((inimg & ~tile_staged).sum())
    safe, inside, st = t["safe"], t["inside"], t["staged"]
    counts.update(staged_tiles=int(st.sum()), unsafe_tiles=int((~safe).sum()),
                  budget_tiles=int((safe & inside & ~st).sum()),
                  outside_tiles=int((safe & ~inside).sum()))
    return counts


def alignment_homographies(landmarks: torch.Tensor, base_pts: torch.Tensor) -> torch.Tensor:
    """``(B, 3, 3)`` maps from ``landmarks (B, 3, 2)`` to ``base_pts (3, 2)``, each
    point set prepended with its centroid rounded half-to-even (``torch.round``,
    as ``np.round`` in the reference), which makes the maps slightly projective."""
    landmarks = landmarks.float()
    base = base_pts.to(landmarks).expand(landmarks.shape[0], 3, 2)
    src4 = torch.cat([torch.round(landmarks.mean(dim=1, keepdim=True)), landmarks], dim=1)
    dst4 = torch.cat([torch.round(base.mean(dim=1, keepdim=True)), base], dim=1)
    return solve_homography(src4, dst4)


def align_crop(images: torch.Tensor, landmarks: torch.Tensor, base_pts: torch.Tensor,
               dsize: tuple[int, int], compute_dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """Batched reference ``align()``: rounded-centroid 4-point homography + warp.

    ``images (B, H, W, C)`` float, ``landmarks (B, 3, 2)`` as ``(x, y)`` (left
    eye, right eye, nose), ``base_pts (3, 2)`` canonical targets. Runs kernel K1
    in ``compute_dtype``'s mode for CUDA tensors. As the JAX ``align_crop``
    runs its kernel only off the CPU and for crop heights that are multiples
    of 8, CPU tensors and other heights take the exact float32 warp whatever
    ``compute_dtype`` says (the plain version on the CPU). Float32 crops.
    """
    _check_warp_dtypes(compute_dtype, torch.float32)
    if images.device.type == "cpu" or dsize[0] % 8:
        compute_dtype = torch.float32
    Hs = alignment_homographies(landmarks, base_pts)
    return warp_perspective_batch_cuda(images.float().contiguous(), Hs, dsize, compute_dtype)
