"""Greedy non-maximum suppression (counterpart of the JAX ``ops/nms.py`` and of
``ops/pallas_nms.py::nms_keep_sorted_batch``).

``nms_keep_sorted_batch`` is the plain PyTorch version of kernel K2 (greedy NMS
over G groups of score-sorted boxes); ``nms_keep_sorted_batch_cuda`` is its
wrapper, which launches ``csrc/nms.cu`` for CUDA tensors and calls the plain
version for CPU tensors. ``nms_keep_sorted`` (one group) and
``nms_keep_sorted_grid`` (G groups) are K5, the JAX package's other two entry
points over the same function (``pallas_nms.py:75`` and ``:191``); they launch
the same kernel, each with its own launch count. ``nms`` is the
index-returning form of the JAX package.
"""

from __future__ import annotations

import torch

from .. import kernels

_NEG_INF = -1e10
# csrc/nms.cu keeps 24 bytes a box in shared memory; a Hopper block may use
# 232,448 bytes of it
NMS_MAX_K = 232448 // 24


def nms_keep_sorted_batch(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_threshold: float) -> torch.Tensor:
    """Plain K2: ``boxes (G, K, 4)`` sorted by score descending per group,
    ``valid (G, K)`` bool -> ``(G, K)`` bool keep mask.

    Box ``j`` dies when a live box ``i < j`` overlaps it with
    ``iou > iou_threshold`` (``union > 0`` guard); invalid boxes neither
    suppress nor survive; areas clamp at 0. The float expressions are those of
    the CUDA kernel, so the two give equal masks.
    """
    boxes = boxes.float()
    G, K, _ = boxes.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    # [g, i, j]: does pivot i suppress column j (before liveness)
    ix1 = torch.maximum(x1[:, None, :], x1[:, :, None])
    iy1 = torch.maximum(y1[:, None, :], y1[:, :, None])
    ix2 = torch.minimum(x2[:, None, :], x2[:, :, None])
    iy2 = torch.minimum(y2[:, None, :], y2[:, :, None])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    union = area[:, None, :] + area[:, :, None] - inter
    iou = torch.where(union > 0, inter / union, torch.zeros_like(inter))
    later = torch.ones(K, K, dtype=torch.bool, device=boxes.device).triu(1)
    suppress = (iou > iou_threshold) & later
    alive = valid.to(torch.bool).clone()
    for i in range(K):
        alive &= ~(suppress[:, i, :] & alive[:, i:i + 1])
    return alive


def _launch_nms(name: str, boxes: torch.Tensor, valid: torch.Tensor,
                iou_threshold: float) -> torch.Tensor:
    """Run ``csrc/nms.cu`` on ``(G, K, 4)`` boxes and count one launch of ``name``."""
    kernels.check_cuda_f32("nms boxes", boxes, 3)
    G, K, four = boxes.shape
    if four != 4 or K > NMS_MAX_K:
        raise ValueError(f"nms boxes: expected (G, K<={NMS_MAX_K}, 4), got {tuple(boxes.shape)}")
    if valid.shape != (G, K) or valid.dtype != torch.bool or not valid.is_contiguous() \
            or valid.device != boxes.device:
        raise ValueError("nms valid: expected a contiguous (G, K) bool tensor "
                         "on the boxes' device")
    keep = torch.empty((G, K), dtype=torch.bool, device=boxes.device)
    if G == 0 or K == 0:
        return keep
    kernels.launch(name, "pfr_nms_keep_sorted_batch", boxes.device, boxes.data_ptr(),
                   valid.data_ptr(), keep.data_ptr(), G, K, float(iou_threshold))
    return keep


def nms_keep_sorted_batch_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                               iou_threshold: float) -> torch.Tensor:
    """K2 wrapper: the CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if boxes.device.type == "cpu":
        return nms_keep_sorted_batch(boxes, valid, iou_threshold)
    return _launch_nms("nms_keep_sorted_batch", boxes, valid, iou_threshold)


def nms_keep_sorted(boxes: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """K5, one group: ``boxes (K, 4)`` sorted by score descending, ``valid (K,)``
    bool -> ``(K,)`` bool keep mask. The CUDA kernel (G = 1) for CUDA tensors,
    the plain K2 for CPU ones."""
    if boxes.device.type == "cpu":
        return nms_keep_sorted_batch(boxes[None], valid[None], iou_threshold)[0]
    if boxes.dim() != 2 or valid.dim() != 1:
        raise ValueError("nms_keep_sorted: expected boxes (K, 4) and valid (K,)")
    return _launch_nms("nms_keep_sorted", boxes[None], valid[None], iou_threshold)[0]


def nms_keep_sorted_grid(boxes: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    """K5, G groups: ``boxes (G, K, 4)``, ``valid (G, K)`` -> ``(G, K)`` bool keep
    masks, the JAX grid entry point's function (one program per group there,
    one block per group here). The CUDA kernel for CUDA tensors, the plain K2
    for CPU ones."""
    if boxes.device.type == "cpu":
        return nms_keep_sorted_batch(boxes, valid, iou_threshold)
    return _launch_nms("nms_keep_sorted_grid", boxes, valid, iou_threshold)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_output: int, valid: torch.Tensor | None = None,
        score_threshold: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over ``(N, 4)`` boxes, the JAX package's index form.

    Returns ``(indices (max_output,) int64, keep_valid (max_output,) bool)``:
    kept boxes in descending-score order (ties: lower index first), padding
    slots index 0.
    """
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    if score_threshold is not None:
        scores = torch.where(scores > score_threshold, scores,
                             torch.full_like(scores, _NEG_INF))
    order = torch.sort(-scores, stable=True).indices
    alive0 = scores[order] > _NEG_INF / 2
    alive = nms_keep_sorted_batch(boxes[order][None], alive0[None], iou_threshold)[0]
    kept = order[alive][:max_output]
    idx = torch.zeros(max_output, dtype=torch.int64, device=boxes.device)
    ok = torch.zeros(max_output, dtype=torch.bool, device=boxes.device)
    idx[: kept.numel()] = kept
    ok[: kept.numel()] = True
    return idx, ok
