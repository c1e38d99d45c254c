"""Letterboxing to a fixed input size (counterpart of the JAX
``utils/collate.py::letterbox_image``), in PyTorch on the image's device.

The geometry is the JAX package's exactly: ``scale = min(H / h, W / w)``, the
resized size ``(round(h * scale), round(w * scale))``, pads ``(dim - new) // 2``
with the image placed at ``(pad_y, pad_x)`` of a zero canvas. The resize is
``F.interpolate(mode="bilinear", align_corners=False)``, which samples where
``cv2.INTER_LINEAR`` samples; uint8 images are rounded back to uint8. cv2's
uint8 resize uses fixed-point weights, so a resized pixel may differ from cv2's
by 1. An image already at its resized size is copied unchanged.

``detection_collate`` (the JAX ``detection_collate``) turns ``[(image,
targets)]`` samples into one fixed-shape batch of numpy arrays: the images
letterboxed on the CPU, their boxes and keypoints mapped into the letterbox
and padded to ``max_boxes`` with a ``valid`` mask, and with ``with_masks``
each box's float mask letterboxed by :func:`letterbox_mask`.

A mask's letterbox must be cv2's to the bit: the mask-IoU metric truncates
the targets with ``astype(int)`` (an interior 0.99999994 counts as 0) and the
mask loss cuts them at 0.5. :func:`resize_linear_f32` is OpenCV 5's float
``INTER_LINEAR`` resize: per axis the source position ``(d + 0.5) * in /
out - 0.5`` in float64, its integer part by ``floor`` and its fraction
rounded to float32; columns clamped to the image with the fraction 0 there,
rows clamped without touching it; then a horizontal and a vertical pass,
each ``fma(b - a, t, a)`` in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def letterbox_geometry(hw: tuple[int, int], size: tuple[int, int]):
    """``(scale, (nh, nw), (pad_x, pad_y))`` of an ``(h, w)`` image
    letterboxed into ``size = (H, W)``."""
    (h, w), (H, W) = hw, size
    scale = min(H / h, W / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return scale, (nh, nw), ((W - nw) // 2, (H - nh) // 2)


def letterbox_image(img: torch.Tensor, size: tuple[int, int]
                    ) -> tuple[torch.Tensor, float, tuple[int, int]]:
    """Aspect-preserving resize of an ``(h, w, C)`` image and a centred pad to
    ``size = (H, W)``. Returns ``(canvas (H, W, C), scale, (pad_x, pad_y))``,
    so that a point maps as ``p' = p * scale + pad``."""
    H, W = size
    h, w = img.shape[:2]
    scale, (nh, nw), (pad_x, pad_y) = letterbox_geometry((h, w), size)
    if (nh, nw) == (h, w):
        resized = img
    else:
        x = img.float().permute(2, 0, 1)[None]
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
        resized = x[0].permute(1, 2, 0)
        if img.dtype == torch.uint8:
            resized = torch.floor(resized + 0.5).clamp(0, 255).to(torch.uint8)
    canvas = img.new_zeros((H, W) + tuple(img.shape[2:]))
    canvas[pad_y:pad_y + nh, pad_x:pad_x + nw] = resized
    return canvas, scale, (pad_x, pad_y)


def _linear_axis(n_out: int, n_in: int) -> tuple[np.ndarray, np.ndarray]:
    """One axis of OpenCV's linear resize: the first tap and the float32
    weight of the second, before clamping."""
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    first = np.floor(pos)
    return first.astype(np.int64), (pos - first).astype(np.float32)


def _lerp_f32(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """float32 ``fma(b - a, t, a)``, rounded once (float64 holds the product
    of two float32 exactly)."""
    return ((b - a).astype(np.float64) * t + a).astype(np.float32)


def resize_linear_f32(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of a
    float32 ``(h0, w0)`` image (a mask) to ``size = (h, w)``, bit for bit
    (see the module docstring); the same size is a copy. Images of several
    channels take other code paths in OpenCV, which are not copied."""
    img = np.asarray(img, np.float32)
    if img.ndim != 2:
        raise ValueError(f"resize_linear_f32 takes one (h, w) plane, not {img.shape}")
    h0, w0 = img.shape
    h, w = size
    if (h, w) == (h0, w0):
        return img.copy()
    x0, tx = _linear_axis(w, w0)
    edge = (x0 < 0) | (x0 >= w0 - 1)
    tx[edge] = 0.0
    x0 = np.clip(x0, 0, w0 - 1)
    x1 = np.minimum(x0 + 1, w0 - 1)
    rows = _lerp_f32(img[:, x0], img[:, x1], tx[None, :])
    y0, ty = _linear_axis(h, h0)
    ty = ty[:, None]
    return _lerp_f32(rows[np.clip(y0, 0, h0 - 1)], rows[np.clip(y0 + 1, 0, h0 - 1)], ty)


def letterbox_mask(mask: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """A float32 ``(h, w)`` mask letterboxed to ``size = (H, W)`` as the JAX
    collate letterboxes it: :func:`letterbox_image`'s geometry with cv2's
    float resize (:func:`resize_linear_f32`)."""
    mask = np.asarray(mask, np.float32)
    _, (nh, nw), (pad_x, pad_y) = letterbox_geometry(mask.shape[:2], size)
    canvas = np.zeros(size, np.float32)
    canvas[pad_y:pad_y + nh, pad_x:pad_x + nw] = resize_linear_f32(mask, (nh, nw))
    return canvas


def detection_collate(samples: list[tuple[np.ndarray, dict]], image_size: tuple[int, int],
                      max_boxes: int = 8, num_keypoints: int = 0,
                      with_masks: bool = False) -> dict[str, np.ndarray]:
    """``[(image, targets)]`` -> ``images (B, H, W, 3)`` float32, ``boxes
    (B, max_boxes, 4)``, ``labels``, ``valid``, with ``num_keypoints``
    ``keypoints (B, max_boxes, num_keypoints, 3)`` and with ``with_masks``
    ``masks (B, max_boxes, H, W)`` float32. ``targets`` holds ``boxes
    (N, 4)``, ``labels (N,)`` and optionally ``keypoints (N, K, 3)`` and
    ``masks (N, h, w)``. A gray
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
    if with_masks:
        out["masks"] = np.zeros((B, max_boxes, H, W), np.float32)
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
            if with_masks and "masks" in tgt:
                for i in range(n):
                    out["masks"][b, i] = letterbox_mask(tgt["masks"][i], (H, W))
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

    def __init__(self, image_size, max_boxes=8, num_keypoints=0, with_masks=False):
        self.image_size = image_size
        self.max_boxes = max_boxes
        self.num_keypoints = num_keypoints
        self.with_masks = with_masks

    def __call__(self, samples):
        return detection_collate(samples, self.image_size, self.max_boxes,
                                 self.num_keypoints, self.with_masks)

