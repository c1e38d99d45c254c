"""Letterboxing to a fixed input size (counterpart of the JAX
``utils/collate.py::letterbox_image``), in PyTorch on the image's device.

The geometry is the JAX package's exactly: ``scale = min(H / h, W / w)``, the
resized size ``(round(h * scale), round(w * scale))``, pads ``(dim - new) // 2``
with the image placed at ``(pad_y, pad_x)`` of a zero canvas. The resize is
``F.interpolate(mode="bilinear", align_corners=False)``, which samples where
``cv2.INTER_LINEAR`` samples; uint8 images are rounded back to uint8. cv2's
uint8 resize uses fixed-point weights, so a resized pixel may differ from cv2's
by 1. An image already at its resized size is copied unchanged.

``detection_collate`` (the JAX ``detection_collate`` without masks) turns
``[(image, targets)]`` samples into one fixed-shape batch of numpy arrays: the
images letterboxed on the CPU, their boxes and keypoints mapped into the
letterbox and padded to ``max_boxes`` with a ``valid`` mask.
"""

from __future__ import annotations

import numpy as np
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


def detection_collate(samples: list[tuple[np.ndarray, dict]], image_size: tuple[int, int],
                      max_boxes: int = 8, num_keypoints: int = 0) -> dict[str, np.ndarray]:
    """``[(image, targets)]`` -> ``images (B, H, W, 3)`` float32, ``boxes
    (B, max_boxes, 4)``, ``labels``, ``valid`` and, with ``num_keypoints``,
    ``keypoints (B, max_boxes, num_keypoints, 3)``. ``targets`` holds ``boxes
    (N, 4)``, ``labels (N,)`` and optionally ``keypoints (N, K, 3)``. A gray
    image is repeated to 3 channels and an alpha channel dropped; a canvas
    whose maximum exceeds 1.5 is divided by 255, as in JAX (so an image with
    no pixel above 1 stays unscaled)."""
    B = len(samples)
    H, W = image_size
    out = {
        "images": np.zeros((B, H, W, 3), np.float32),
        "boxes": np.zeros((B, max_boxes, 4), np.float32),
        "labels": np.zeros((B, max_boxes), np.int32),
        "valid": np.zeros((B, max_boxes), bool),
    }
    if num_keypoints:
        out["keypoints"] = np.zeros((B, max_boxes, num_keypoints, 3), np.float32)

    for b, (img, tgt) in enumerate(samples):
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        if img.shape[-1] == 4:
            img = img[..., :3]
        canvas, scale, (px, py) = letterbox_image(torch.from_numpy(np.ascontiguousarray(img)),
                                                  (H, W))
        canvas = canvas.float()
        if canvas.max() > 1.5:  # uint8-range input
            canvas = canvas / 255.0
        out["images"][b] = canvas.numpy()

        boxes = np.asarray(tgt.get("boxes", np.zeros((0, 4))), np.float32)
        n = min(len(boxes), max_boxes)
        if n:
            scaled = boxes[:n] * scale + np.asarray([px, py, px, py], np.float32)
            out["boxes"][b, :n] = scaled
            out["labels"][b, :n] = np.asarray(tgt["labels"])[:n]
            out["valid"][b, :n] = True
            if num_keypoints and "keypoints" in tgt:
                kps = np.asarray(tgt["keypoints"], np.float32)[:n].copy()
                kps[..., 0] = kps[..., 0] * scale + px
                kps[..., 1] = kps[..., 1] * scale + py
                out["keypoints"][b, :n] = kps
    return out


def key_points_collate_list_fn(samples, image_size=(640, 640), max_boxes=8, num_keypoints=3):
    """The keypoint collate under the reference's name."""
    return detection_collate(samples, image_size, max_boxes=max_boxes,
                             num_keypoints=num_keypoints)


class DetectionCollate:
    """:func:`detection_collate` with its settings bound, for a loader."""

    def __init__(self, image_size, max_boxes=8, num_keypoints=0):
        self.image_size = image_size
        self.max_boxes = max_boxes
        self.num_keypoints = num_keypoints

    def __call__(self, samples):
        return detection_collate(samples, self.image_size, self.max_boxes,
                                 self.num_keypoints)

