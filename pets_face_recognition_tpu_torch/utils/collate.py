"""Letterboxing to a fixed input size (counterpart of the JAX
``utils/collate.py::letterbox_image``), in PyTorch on the image's device.

The geometry is the JAX package's exactly: ``scale = min(H / h, W / w)``, the
resized size ``(round(h * scale), round(w * scale))``, pads ``(dim - new) // 2``
with the image placed at ``(pad_y, pad_x)`` of a zero canvas. The resize is
``F.interpolate(mode="bilinear", align_corners=False)``, which samples where
``cv2.INTER_LINEAR`` samples; uint8 images are rounded back to uint8. cv2's
uint8 resize uses fixed-point weights, so a resized pixel may differ from cv2's
by 1. An image already at its resized size is copied unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def letterbox_image(img: torch.Tensor, size: tuple[int, int]
                    ) -> tuple[torch.Tensor, float, tuple[int, int]]:
    """Aspect-preserving resize of an ``(h, w, C)`` image and a centred pad to
    ``size = (H, W)``. Returns ``(canvas (H, W, C), scale, (pad_x, pad_y))``,
    so that a point maps as ``p' = p * scale + pad``."""
    H, W = size
    h, w = img.shape[:2]
    scale = min(H / h, W / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) == (h, w):
        resized = img
    else:
        x = img.float().permute(2, 0, 1)[None]
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
        resized = x[0].permute(1, 2, 0)
        if img.dtype == torch.uint8:
            resized = torch.floor(resized + 0.5).clamp(0, 255).to(torch.uint8)
    canvas = img.new_zeros((H, W) + tuple(img.shape[2:]))
    pad_y = (H - nh) // 2
    pad_x = (W - nw) // 2
    canvas[pad_y:pad_y + nh, pad_x:pad_x + nw] = resized
    return canvas, scale, (pad_x, pad_y)
