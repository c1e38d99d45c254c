"""Region proposal network (counterpart of the JAX ``models/rpn.py``).

Proposals, per image: head logits -> per-level top-``pre_nms_top_n`` ->
decode + clip -> drop tiny boxes (filtering on sigmoid probability, as
torchvision) -> greedy NMS per (image, level) through kernel K2 -> global
top-``post_nms_top_n``, at the eval or the training budgets. Training adds the
anchor matcher, the balanced sampler and the RPN loss, batched over images.
Every shape is fixed; invalid entries ride along with validity masks. Top-k
and argsort run as stable sorts, so ties keep the lower index first, as
``lax.top_k`` and ``jnp.argsort``. The sampler takes its uniform noise as an
argument, so that a caller can hand both frameworks the same numbers.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
from torch import nn

from ..losses import optax_sigmoid_ce, smooth_l1
from ..ops.boxes import clip_boxes, decode_boxes, encode_boxes, pairwise_iou
from ..ops.nms import nms_keep_sorted_batch_cuda
from .layers import Conv2d, check_quant_dtype
from .quant import ActQuant, QuantConv


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness / box-delta heads (torchvision names).

    ``forward`` takes the NCHW levels in order and returns ``(B, N)`` logits and
    ``(B, N, 4)`` deltas, anchors ordered ``(level, y, x, anchor)``. With
    ``quant`` the shared conv is one :class:`~.quant.QuantConv` (with its
    bias) behind one :class:`~.quant.ActQuant` a level (``conv_q.{l}``, the
    JAX ``conv_q_{lvl}`` in level order); ``cls_logits`` and ``bbox_pred``
    stay float. ``dtype`` is the compute dtype of the shared conv and of both
    1x1 predictors (JAX ``rpn.py:61-65``), so the logits and deltas come out
    in it; the proposals upcast as JAX's do (the boxes are float32).
    """

    def __init__(self, in_channels: int, num_anchors: int, quant: str | None = None,
                 num_levels: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        check_quant_dtype(quant, dtype)
        self.quant = quant is not None
        conv = partial(Conv2d, dtype=dtype) if quant is None else partial(QuantConv, mode=quant)
        self.conv = conv(in_channels, in_channels, 3, padding=1)
        self.cls_logits = Conv2d(in_channels, num_anchors, 1, dtype=dtype)
        self.bbox_pred = Conv2d(in_channels, num_anchors * 4, 1, dtype=dtype)
        if self.quant:
            self.conv_q = nn.ModuleList(ActQuant(quant) for _ in range(num_levels))

    def forward(self, feats: Sequence[torch.Tensor]):
        logits, deltas = [], []
        for lvl, x in enumerate(feats):
            t = torch.relu(self.conv(*self.conv_q[lvl](x)) if self.quant else self.conv(x))
            B = t.shape[0]
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1).reshape(B, -1))
            deltas.append(self.bbox_pred(t).permute(0, 2, 3, 1).reshape(B, -1, 4))
        return torch.cat(logits, 1), torch.cat(deltas, 1)


class RPN(nn.Module):
    """Holds the head under torchvision's ``rpn.head`` name."""

    def __init__(self, in_channels: int, num_anchors: int, quant: str | None = None,
                 num_levels: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head = RPNHead(in_channels, num_anchors, quant, num_levels, dtype)

    def forward(self, feats: Sequence[torch.Tensor]):
        return self.head(feats)


def level_sizes(feature_sizes: Sequence[tuple[int, int]], num_anchors: int) -> list[int]:
    """Anchors per level (the port's ``_level_ids``: level ``l`` owns a run of
    ``H_l * W_l * A`` consecutive anchors)."""
    return [h * w * num_anchors for h, w in feature_sizes]


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: descending, ties lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic of the RPN's logits: ``torch.sigmoid`` in float32; in
    bfloat16, JAX's ``1 / (1 + exp(-x))`` with every op rounded to bfloat16,
    as XLA computes ``jax.nn.sigmoid`` there, so that ties among the
    proposals' scores, which the top-k breaks by index, are JAX's ties."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def generate_proposals(objectness: torch.Tensor, deltas: torch.Tensor,
                       anchors: torch.Tensor, level_counts: Sequence[int],
                       image_size: tuple[int, int], pre_nms_top_n: int,
                       post_nms_top_n: int, nms_thresh: float = 0.7,
                       min_size: float = 1e-3, score_thresh: float = 0.0,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched eval proposals.

    ``objectness (B, N)`` logits, ``deltas (B, N, 4)``, ``anchors (N, 4)``,
    ``level_counts``: anchors per level. Returns ``(B, post_nms_top_n, 4)``
    proposals and a ``(B, post_nms_top_n)`` validity mask. bfloat16 logits
    and deltas (a bfloat16 head) are handled as XLA computes JAX's
    ``generate_proposals`` on them: the logits ranked and scored in bfloat16
    (:func:`_sigmoid`), the deltas decoded in float32 (XLA keeps the float32
    intermediates of that elementwise chain), so the boxes, K2's input, are
    float32.
    """
    deltas = deltas.float()
    B = objectness.shape[0]
    L = len(level_counts)
    k = min(pre_nms_top_n, max(level_counts))
    starts = [sum(level_counts[:i]) for i in range(L)]

    lvl_boxes, lvl_scores, lvl_valid = [], [], []
    for start, n in zip(starts, level_counts):
        s = objectness[:, start:start + n]
        d = deltas[:, start:start + n]
        a = anchors[start:start + n]
        kk = min(k, n)
        top_s, top_i = _top_k(s, kk)
        boxes = decode_boxes(torch.gather(d, 1, top_i[..., None].expand(B, kk, 4)),
                             a[top_i])
        boxes = clip_boxes(boxes, image_size)
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        # torchvision filters on sigmoid PROBABILITIES, not logits
        valid = ((w >= min_size) & (h >= min_size)
                 & (_sigmoid(top_s) >= score_thresh) & torch.isfinite(top_s))
        pad = k - kk
        if pad:
            boxes = nn.functional.pad(boxes, (0, 0, 0, pad))
            top_s = nn.functional.pad(top_s, (0, pad), value=float("-inf"))
            valid = nn.functional.pad(valid, (0, pad))
        lvl_boxes.append(boxes)
        lvl_scores.append(top_s)
        lvl_valid.append(valid)

    boxes = torch.stack(lvl_boxes, 1).reshape(B * L, k, 4).contiguous()
    scores_k = torch.stack(lvl_scores, 1).reshape(B * L, k)
    valid = torch.stack(lvl_valid, 1).reshape(B * L, k).contiguous()

    keep = nms_keep_sorted_batch_cuda(boxes, valid, nms_thresh)   # kernel K2
    kept_scores = torch.where(keep, _sigmoid(scores_k),
                              torch.full_like(scores_k, float("-inf")))

    flat_boxes = boxes.reshape(B, L * k, 4)
    flat_scores = kept_scores.reshape(B, L * k)
    flat_keep = keep.reshape(B, L * k)
    top_s, top_i = _top_k(flat_scores, post_nms_top_n)
    out_boxes = torch.gather(flat_boxes, 1, top_i[..., None].expand(B, post_nms_top_n, 4))
    out_keep = torch.gather(flat_keep, 1, top_i) & (top_s > float("-inf"))
    return out_boxes, out_keep


def batched_iou(boxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """IoU of ``boxes`` (``(N, 4)`` shared, or ``(B, N, 4)``) against each
    image's ``gt_boxes (B, M, 4)``: ``(B, N, M)``."""
    return torch.stack([pairwise_iou(boxes if boxes.dim() == 2 else boxes[b], g)
                        for b, g in enumerate(gt_boxes)])


def assign_rpn_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                       gt_valid: torch.Tensor, fg_iou_thresh: float = 0.7,
                       bg_iou_thresh: float = 0.3) -> tuple[torch.Tensor, torch.Tensor]:
    """Anchor labels ``(B, N)`` (1 fg, 0 bg, -1 ignore) and matched GT boxes
    ``(B, N, 4)``: torchvision ``Matcher`` with low-quality matches (an anchor
    whose IoU with a valid GT equals that GT's best, and is above 0, is fg)."""
    iou = batched_iou(anchors, gt_boxes)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.max(dim=2)
    labels = torch.full_like(best_gt, -1, dtype=torch.int32)
    labels = torch.where(best_iou < bg_iou_thresh, 0, labels)
    labels = torch.where(best_iou >= fg_iou_thresh, 1, labels)
    per_gt_best = torch.where(gt_valid, iou.max(dim=1).values,
                              torch.full_like(gt_valid, -2.0, dtype=iou.dtype))
    is_best = ((iou == per_gt_best[:, None, :]) & gt_valid[:, None, :]
               & (iou > 0)).any(dim=2)
    labels = torch.where(is_best, 1, labels)
    matched = torch.gather(gt_boxes, 1, best_gt[..., None].expand(*best_gt.shape, 4))
    return labels, matched


def sample_balanced(labels: torch.Tensor, noise: torch.Tensor, batch_size: int = 256,
                    positive_fraction: float = 0.5) -> torch.Tensor:
    """Balanced fg/bg sampling along the last axis with uniform ``noise`` of the
    same shape: float mask, 1.0 for sampled entries. Up to
    ``batch_size * positive_fraction`` positives, the rest negatives; the ones
    taken are those with the least noise (ranks by two stable argsorts)."""
    n_pos_budget = int(batch_size * positive_fraction)
    is_pos = labels == 1
    is_neg = labels == 0
    n_pos = is_pos.sum(-1, keepdim=True).clamp(max=n_pos_budget)
    n_neg = torch.minimum(is_neg.sum(-1, keepdim=True), batch_size - n_pos)
    two = torch.full_like(noise, 2.0)

    def rank(mask):
        return torch.argsort(torch.argsort(torch.where(mask, noise, two), dim=-1,
                                           stable=True), dim=-1, stable=True)

    sampled = (is_pos & (rank(is_pos) < n_pos)) | (is_neg & (rank(is_neg) < n_neg))
    return sampled.float()


def rpn_loss(objectness: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
             gt_boxes: torch.Tensor, gt_valid: torch.Tensor, noise: torch.Tensor,
             batch_size_per_image: int = 256, positive_fraction: float = 0.5,
             ) -> dict[str, torch.Tensor]:
    """RPN loss (torchvision normalisation: both terms over the sampled count
    per image, then the mean over images). ``noise (B, N)`` feeds the sampler.
    Being a mean of per-image terms, a data-parallel step over equal shards
    needs no whole-batch count here: the mean over the ranks of each rank's
    mean is the whole-batch mean."""
    labels, matched = assign_rpn_targets(anchors, gt_boxes, gt_valid)
    sampled = sample_balanced(labels, noise, batch_size_per_image, positive_fraction)
    n_sampled = sampled.sum(-1).clamp(min=1.0)
    is_fg = (labels == 1).float()
    cls = optax_sigmoid_ce(objectness, is_fg)
    cls_loss = (cls * sampled).sum(-1) / n_sampled
    reg = smooth_l1(deltas, encode_boxes(matched, anchors)).sum(-1)
    reg_loss = (reg * (sampled * is_fg)).sum(-1) / n_sampled
    return {"loss_objectness": cls_loss.mean(), "loss_rpn_box_reg": reg_loss.mean()}
