"""Homography solve and projective warp (counterpart of the JAX ``ops/homography.py``
and of ``ops/pallas_warp.py::warp_affine_batch_pallas``).

Images are NHWC; landmarks are ``(B, 3, 2)`` as ``(x, y)``. ``warp_perspective``
(one image) and ``warp_perspective_batch`` are the plain PyTorch version of
kernel K1 (with :func:`invert_homographies`, the closed-form inverse the
kernel repeats); ``warp_perspective_batch_cuda`` is its wrapper, which launches
``csrc/warp.cu`` for CUDA tensors and calls the plain version for CPU tensors.
``align_crop`` is the reference ``align()``: centroid-augmented 4-point
homography, then the projective warp.
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


def _bilinear_sample(images: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor):
    """Sample NHWC ``images`` at float coords ``sx, sy (B, oh, ow)``; zero outside."""
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

    w00 = ((1 - fy) * (1 - fx))[..., None]
    w01 = ((1 - fy) * fx)[..., None]
    w10 = (fy * (1 - fx))[..., None]
    w11 = (fy * fx)[..., None]
    return (tap(y0, x0) * w00 + tap(y0, x0 + 1) * w01
            + tap(y0 + 1, x0) * w10 + tap(y0 + 1, x0 + 1) * w11)


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
                           dsize: tuple[int, int]) -> torch.Tensor:
    """Plain K1: ``(B, H, W, C) x (B, 3, 3) -> (B, out_h, out_w, C)`` float32.

    cv2 ``warpPerspective`` semantics: output pixel ``(x, y)`` bilinearly samples
    the source at ``H^-1 @ (x, y, 1)``, zero outside the image; ``H^-1`` from
    :func:`invert_homographies`.
    """
    sx, sy = _sample_coords(invert_homographies(Hs), dsize)
    return _bilinear_sample(images.float(), sx, sy)


def warp_perspective(image: torch.Tensor, H: torch.Tensor,
                     dsize: tuple[int, int]) -> torch.Tensor:
    """One ``(H, W, C)`` image: :func:`warp_perspective_batch` of a batch of one."""
    return warp_perspective_batch(image[None], H[None], dsize)[0]


def warp_perspective_batch_cuda(images: torch.Tensor, Hs: torch.Tensor,
                                dsize: tuple[int, int]) -> torch.Tensor:
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

    One launch: the kernel inverts each ``H`` itself, as :func:`invert_homographies`
    does. Takes contiguous float32 ``(B, H, W, C<=4)`` images and ``(B, 3, 3)``
    maps on the same device.
    """
    if images.device.type == "cpu":
        return warp_perspective_batch(images, Hs, dsize)
    kernels.check_cuda_f32("warp images", images, 4)
    kernels.check_cuda_f32("warp maps", Hs, 3)
    B, H, W, C = images.shape
    if C > 4 or Hs.shape != (B, 3, 3) or Hs.device != images.device:
        raise ValueError(f"warp: expected (B,H,W,C<=4) images and (B,3,3) H, got "
                         f"{tuple(images.shape)} and {tuple(Hs.shape)}")
    out_h, out_w = dsize
    out = images.new_empty((B, out_h, out_w, C))
    if out.numel() == 0:
        return out
    kernels.launch("warp_perspective_batch", "pfr_warp_perspective_batch", images.device,
                   images.data_ptr(), Hs.data_ptr(), out.data_ptr(), B, H, W, C,
                   out_h, out_w)
    return out


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
               dsize: tuple[int, int]) -> torch.Tensor:
    """Batched reference ``align()``: rounded-centroid 4-point homography + warp.

    ``images (B, H, W, C)`` float, ``landmarks (B, 3, 2)`` as ``(x, y)`` (left
    eye, right eye, nose), ``base_pts (3, 2)`` canonical targets. Runs kernel K1
    for CUDA tensors and the plain version for CPU tensors.
    """
    Hs = alignment_homographies(landmarks, base_pts)
    return warp_perspective_batch_cuda(images.float().contiguous(), Hs, dsize)
