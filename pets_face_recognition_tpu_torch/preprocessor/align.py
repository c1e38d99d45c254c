"""Alignment API (counterpart of the JAX ``preprocessor/align.py``).

``align(img, pts, base_pts, dsize)`` keeps the reference's single-image
signature; ``align_batch`` is the batched path. Both are
``ops.homography.align_crop``: a 4-point homography from the landmarks and
their rounded centroid, then the projective warp, which is kernel K1 for CUDA
tensors and its plain version for CPU ones.
"""

from __future__ import annotations

import torch

from ..ops.homography import align_crop, solve_homography, warp_perspective

__all__ = ["align", "align_batch", "solve_homography", "warp_perspective"]


def align(img: torch.Tensor, pts, base_pts, dsize) -> torch.Tensor:
    """One ``(H, W, C)`` image and its ``(3, 2)`` landmarks -> the aligned
    ``(out_h, out_w, C)`` crop on the image's device. ``dsize`` takes the
    reference's ``(H, W, C)`` tuples (the channel entry is ignored)."""
    img = torch.as_tensor(img)
    pts = torch.as_tensor(pts, dtype=torch.float32, device=img.device)
    base = torch.as_tensor(base_pts, dtype=torch.float32, device=img.device)
    return align_batch(img[None], pts[None], base, dsize)[0]


def align_batch(images: torch.Tensor, landmarks: torch.Tensor, base_pts: torch.Tensor,
                dsize) -> torch.Tensor:
    """``(B, H, W, C) x (B, 3, 2) -> (B, out_h, out_w, C)`` float32."""
    return align_crop(images, landmarks, base_pts, tuple(dsize[:2]))
