"""Greedy non-maximum suppression (counterpart of the JAX ``ops/nms.py`` and of
``ops/pallas_nms.py::nms_keep_sorted_batch``).

``nms_keep_sorted_batch`` is the plain PyTorch version of kernel K2 (greedy NMS
over G groups of score-sorted boxes); ``nms_keep_sorted_batch_cuda`` is its
wrapper, which launches ``csrc/nms.cu`` (a bitmask IoU pass, then a sweep a
group) for CUDA tensors and calls the plain version for CPU tensors;
``nms_suppress_words`` and ``nms_sweep_words`` are the plain twins of the two
passes, for the tests. ``nms_keep_sorted`` (one group) and
``nms_keep_sorted_grid`` (G groups) are K5, the JAX package's other two entry
points over the same function (``pallas_nms.py:75`` and ``:191``); they launch
the same kernels, each with its own launch count. ``nms`` is the
index-returning form of the JAX package, over the K2 wrapper.
"""

from __future__ import annotations

import torch

from .. import kernels

_NEG_INF = -1e10
NMS_WORD = 64
# csrc/nms.cu's sweep holds two chunks of a group's words, 64 rows of up to
# ceil(K / 64) words padded to 65 rows, in the 232,448 bytes of shared memory
# that a Hopper block may use
NMS_MAX_K = NMS_WORD * (232448 // (2 * (NMS_WORD + 1) * 8))


def suppress_matrix(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """``(G, K, K)`` bool: ``[g, i, j]`` is whether pivot ``i`` would suppress
    box ``j`` of group ``g`` (``j > i`` and ``iou > iou_threshold``), before
    liveness. The float expressions are those of the CUDA kernels."""
    boxes = boxes.float()
    K = boxes.shape[1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ix1 = torch.maximum(x1[:, None, :], x1[:, :, None])
    iy1 = torch.maximum(y1[:, None, :], y1[:, :, None])
    ix2 = torch.minimum(x2[:, None, :], x2[:, :, None])
    iy2 = torch.minimum(y2[:, None, :], y2[:, :, None])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    union = area[:, None, :] + area[:, :, None] - inter
    iou = torch.where(union > 0, inter / union, torch.zeros_like(inter))
    later = torch.ones(K, K, dtype=torch.bool, device=boxes.device).triu(1)
    return (iou > iou_threshold) & later


def nms_keep_sorted_batch(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_threshold: float) -> torch.Tensor:
    """Plain K2: ``boxes (G, K, 4)`` sorted by score descending per group,
    ``valid (G, K)`` bool -> ``(G, K)`` bool keep mask.

    Box ``j`` dies when a live box ``i < j`` overlaps it with
    ``iou > iou_threshold`` (``union > 0`` guard); invalid boxes neither
    suppress nor survive; areas clamp at 0. The float expressions are those of
    the CUDA kernel, so the two give equal masks.
    """
    K = boxes.shape[1]
    suppress = suppress_matrix(boxes, iou_threshold)
    alive = valid.to(torch.bool).clone()
    for i in range(K):
        alive &= ~(suppress[:, i, :] & alive[:, i:i + 1])
    return alive


def nms_suppress_words(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Plain twin of K2's first pass, in the kernel's layout: ``(G, n, n, 64)``
    int64 for ``n = ceil(K / 64)`` chunks of 64 pivots; ``[g, c, w, t]`` is word
    ``w`` of pivot ``64 * c + t``, whose bit ``b`` is :func:`suppress_matrix`'s
    ``[g, 64 * c + t, 64 * w + b]``. The kernel writes only the words
    ``w >= c`` of valid pivots (the rest are 0 here), and the sweep reads no
    other."""
    G, K = boxes.shape[:2]
    n = -(-K // NMS_WORD)
    pad = n * NMS_WORD - K
    sup = torch.nn.functional.pad(suppress_matrix(boxes, iou_threshold), (0, pad, 0, pad))
    bits = sup.reshape(G, n, NMS_WORD, n, NMS_WORD).long()
    # distinct powers of two, bit 63 as int64's sign: the sum cannot overflow
    words = (bits << torch.arange(NMS_WORD, device=boxes.device)).sum(-1)
    return words.transpose(2, 3).contiguous()


def nms_sweep_words(words: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain twin of K2's second pass: the greedy sweep over the words of
    :func:`nms_suppress_words` -> ``(G, K)`` bool keep mask.

    ``removed`` holds one bit a box (invalid boxes and those past K start
    removed). For each chunk ``c`` of 64 pivots: decide them in order from
    word ``c`` (a kept pivot ORs its word ``c`` in), then OR the words of the
    chunk's kept pivots into the words after ``c``.
    """
    G, K = valid.shape
    n = words.shape[1]
    flags = torch.nn.functional.pad(~valid.to(torch.bool), (0, n * NMS_WORD - K),
                                    value=True).reshape(G, n, NMS_WORD).long()
    removed = (flags << torch.arange(NMS_WORD, device=words.device)).sum(-1)
    keep = torch.zeros(G, K, dtype=torch.bool, device=words.device)
    zero = torch.zeros((), dtype=torch.int64, device=words.device)
    for c in range(n):
        rows = range(min(NMS_WORD, K - c * NMS_WORD))
        for t in rows:
            keep[:, c * NMS_WORD + t] = ((removed[:, c] >> t) & 1) == 0
            removed[:, c] |= torch.where(keep[:, c * NMS_WORD + t], words[:, c, c, t], zero)
        for t in rows:
            removed[:, c + 1:] |= torch.where(keep[:, c * NMS_WORD + t, None],
                                              words[:, c, c + 1:, t], zero)
    return keep


def nms_keep_sorted_batch_two_pass(boxes: torch.Tensor, valid: torch.Tensor,
                                   iou_threshold: float) -> torch.Tensor:
    """K2's two-pass algorithm in plain tensor ops (words, then sweep); the
    same keep mask as :func:`nms_keep_sorted_batch`."""
    return nms_sweep_words(nms_suppress_words(boxes, iou_threshold), valid)


def _launch_nms(name: str, boxes: torch.Tensor, valid: torch.Tensor,
                iou_threshold: float) -> torch.Tensor:
    """Run ``csrc/nms.cu`` on ``(G, K, 4)`` boxes and count one launch of ``name``."""
    kernels.check_cuda_f32("nms boxes", boxes, 3)
    G, K, four = boxes.shape
    if four != 4 or K > NMS_MAX_K:
        raise ValueError(f"nms boxes: expected (G, K<={NMS_MAX_K}, 4), got {tuple(boxes.shape)}")
    if boxes.data_ptr() % 16:
        raise ValueError("nms boxes: the kernel reads a box as 16 aligned bytes")
    if valid.shape != (G, K) or valid.dtype != torch.bool or not valid.is_contiguous() \
            or valid.device != boxes.device:
        raise ValueError("nms valid: expected a contiguous (G, K) bool tensor "
                         "on the boxes' device")
    keep = torch.empty((G, K), dtype=torch.bool, device=boxes.device)
    if G == 0 or K == 0:
        return keep
    # the first pass's words (nms_suppress_words' layout); only those that the
    # sweep reads are written
    n = -(-K // NMS_WORD)
    words = torch.empty((G, n, n, NMS_WORD), dtype=torch.int64, device=boxes.device)
    kernels.launch(name, "pfr_nms_keep_sorted_batch", boxes.device, boxes.data_ptr(),
                   valid.data_ptr(), words.data_ptr(), keep.data_ptr(), G, K,
                   float(iou_threshold))
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
    bool -> ``(K,)`` bool keep mask. K2's kernels (G = 1) for CUDA tensors,
    the plain K2 for CPU ones."""
    if boxes.device.type == "cpu":
        return nms_keep_sorted_batch(boxes[None], valid[None], iou_threshold)[0]
    if boxes.dim() != 2 or valid.dim() != 1:
        raise ValueError("nms_keep_sorted: expected boxes (K, 4) and valid (K,)")
    return _launch_nms("nms_keep_sorted", boxes[None], valid[None], iou_threshold)[0]


def nms_keep_sorted_grid(boxes: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    """K5, G groups: ``boxes (G, K, 4)``, ``valid (G, K)`` -> ``(G, K)`` bool keep
    masks, the JAX grid entry point's function (one program per group there).
    K2's kernels for CUDA tensors, the plain K2 for CPU ones."""
    if boxes.device.type == "cpu":
        return nms_keep_sorted_batch(boxes, valid, iou_threshold)
    return _launch_nms("nms_keep_sorted_grid", boxes, valid, iou_threshold)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_output: int, valid: torch.Tensor | None = None,
        score_threshold: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over ``(N, 4)`` boxes, the JAX package's index form.

    Returns ``(indices (max_output,) int64, keep_valid (max_output,) bool)``:
    kept boxes in descending-score order (ties: lower index first), padding
    slots index 0. The keep mask is K2's: the kernel for CUDA tensors.
    """
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    if score_threshold is not None:
        scores = torch.where(scores > score_threshold, scores,
                             torch.full_like(scores, _NEG_INF))
    order = torch.sort(-scores, stable=True).indices
    alive0 = scores[order] > _NEG_INF / 2
    alive = nms_keep_sorted_batch_cuda(boxes.float()[order][None], alive0[None],
                                       iou_threshold)[0]
    kept = order[alive][:max_output]
    idx = torch.zeros(max_output, dtype=torch.int64, device=boxes.device)
    ok = torch.zeros(max_output, dtype=torch.bool, device=boxes.device)
    idx[: kept.numel()] = kept
    ok[: kept.numel()] = True
    return idx, ok
