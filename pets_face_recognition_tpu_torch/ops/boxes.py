"""Box math: IoU, clip, encode/decode (counterpart of the JAX ``ops/boxes.py``).

Boxes are ``(x1, y1, x2, y2)`` pixel coordinates; torchvision ``BoxCoder``
conventions, with ``dw/dh`` clamped at ``log(1000/16)`` before ``exp``.
"""

from __future__ import annotations

import math

import torch

# torchvision BoxCoder's bbox_xform_clip = log(1000/16).
_BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Areas of ``(..., 4)`` xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * (
        boxes[..., 3] - boxes[..., 1]).clamp(min=0)


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU matrix ``(N, M)`` of xyxy boxes ``(N, 4)`` and ``(M, 4)``."""
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(boxes1)[:, None] + area(boxes2)[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def clip_boxes(boxes: torch.Tensor, image_size: tuple[int, int]) -> torch.Tensor:
    """Clip xyxy boxes to ``image_size = (height, width)``."""
    h, w = image_size
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)],
                       dim=-1)


def _xyxy_to_cxcywh(boxes: torch.Tensor):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h, w, h


def encode_boxes(reference_boxes: torch.Tensor, anchors: torch.Tensor,
                 weights: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
                 ) -> torch.Tensor:
    """Encode ground-truth boxes relative to anchors (BoxCoder.encode)."""
    wx, wy, ww, wh = weights
    gcx, gcy, gw, gh = _xyxy_to_cxcywh(reference_boxes)
    acx, acy, aw, ah = _xyxy_to_cxcywh(anchors)
    aw = aw.clamp(min=1e-6)
    ah = ah.clamp(min=1e-6)
    return torch.stack([wx * (gcx - acx) / aw, wy * (gcy - acy) / ah,
                        ww * torch.log(gw.clamp(min=1e-6) / aw),
                        wh * torch.log(gh.clamp(min=1e-6) / ah)], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
                 ) -> torch.Tensor:
    """Decode ``(..., 4)`` regression deltas against broadcastable xyxy anchors."""
    wx, wy, ww, wh = weights
    acx, acy, aw, ah = _xyxy_to_cxcywh(anchors)
    tx = deltas[..., 0] / wx
    ty = deltas[..., 1] / wy
    tw = (deltas[..., 2] / ww).clamp(max=_BBOX_XFORM_CLIP)
    th = (deltas[..., 3] / wh).clamp(max=_BBOX_XFORM_CLIP)
    cx = tx * aw + acx
    cy = ty * ah + acy
    w = torch.exp(tw) * aw
    h = torch.exp(th) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h],
                       dim=-1)
