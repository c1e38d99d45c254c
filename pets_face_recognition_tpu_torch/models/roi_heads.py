"""RoI heads (counterpart of the JAX ``models/roi_heads.py``): the box, mask
and keypoint heads, the eval postprocess (top-1, or class-aware NMS through
kernel K2) and keypoint decode, and for training the proposal sampler, the
Fast R-CNN loss, the mask targets (each positive's ground-truth mask
projected onto its box) and loss, and the keypoint heatmap targets and loss.

torchvision module names (``box_head.fc6``, ``box_predictor.cls_score``,
``mask_head.mask_fcn{1..4}``, ``mask_predictor.{conv5_mask,mask_fcn_logits}``,
``keypoint_head.{0,2,..,14}``, ``keypoint_predictor.kps_score_lowres``). The
heads take the JAX layout: pooled RoIs ``(K, oh, ow, C)`` NHWC. ``fc6``
flattens that NHWC block in ``(h, w, c)`` order, as the JAX ``TwoMLPHead`` does,
so weights carried over from the JAX package give the same numbers.

``dtype`` is the heads' compute dtype (JAX ``models/roi_heads.py``):
``TwoMLPHead``, the mask head's four convolutions and ``conv5_mask``, and
the keypoint head's eight convolutions compute in it; the layers that JAX
pins to float32 stay float32 whatever it is: the box predictor, the mask
logits (``mask_fcn_logits``) and the keypoint predictor's
``kps_score_lowres`` (with its upsample), so logits and heatmaps are float32.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel
from ..losses import cross_entropy, optax_sigmoid_ce, smooth_l1
from ..ops.boxes import clip_boxes, decode_boxes, encode_boxes
from ..ops.nms import nms_keep_sorted_batch_cuda
from .layers import Conv2d, ConvTranspose2d, Linear
from .quant import ActQuant, QuantConv
from .rpn import _top_k, batched_iou, sample_balanced

BOX_CODER_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


class TwoMLPHead(nn.Module):
    """flatten -> fc6 -> relu -> fc7 -> relu. ``input_dtype``: the type in
    which ``fc6`` reads the pooled RoIs (its compute dtype)."""

    def __init__(self, in_features: int, representation_size: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_dtype = dtype
        self.fc6 = Linear(in_features, representation_size, dtype=dtype)
        self.fc7 = Linear(representation_size, representation_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        return torch.relu(self.fc7(torch.relu(self.fc6(x))))


class FastRCNNPredictor(nn.Module):
    """``cls_score`` (C classes incl. background) and ``bbox_pred`` (4C), in
    float32 on float32 input (a bfloat16 input is cast, as flax does)."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes)
        self.bbox_pred = Linear(in_features, num_classes * 4)

    def forward(self, x: torch.Tensor):
        x = x.float()
        return self.cls_score(x), self.bbox_pred(x).reshape(x.shape[0], -1, 4)


class MaskHead(nn.Module):
    """4 x (conv3x3 + relu) at 256 channels (torchvision ``MaskRCNNHeads``,
    0.12 names); NCHW in and out; ``input_dtype`` as :class:`TwoMLPHead`'s."""

    def __init__(self, in_channels: int, channels: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_dtype = dtype
        for i in range(1, 5):
            setattr(self, f"mask_fcn{i}", Conv2d(in_channels if i == 1 else channels,
                                                 channels, 3, padding=1, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = torch.relu(getattr(self, f"mask_fcn{i}")(x))
        return x


class MaskPredictor(nn.Module):
    """Transposed conv (2, stride 2) + relu, then the 1x1 per-class logits
    (torchvision ``MaskRCNNPredictor``); NCHW in, ``(K, 2S, 2S, C)`` NHWC
    logits out, as the JAX ``MaskHead`` returns them. ``conv5_mask`` computes
    in ``dtype``, the logits in float32."""

    def __init__(self, in_channels: int, num_classes: int, channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv5_mask = ConvTranspose2d(in_channels, channels, 2, 2, dtype=dtype)
        self.mask_fcn_logits = Conv2d(channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mask_fcn_logits(torch.relu(self.conv5_mask(x))).permute(0, 2, 3, 1)


class KeypointHead(nn.Module):
    """8 x (conv3x3 + relu) at 512 channels (torchvision ``KeypointRCNNHeads``:
    the convolutions at ``0, 2, .., 14``, the ReLUs between); NCHW in and out.

    With ``quant`` each convolution is a :class:`~.quant.QuantConv` with its
    bias behind its own :class:`~.quant.ActQuant` (``kps_q.{i}``, the JAX
    ``kps_q{i+1}`` -> ``kps_fcn{i+1}`` pairs), its output in ``dtype``; the
    ReLUs stay in it. ``input_dtype`` is the type in which the head reads the
    pooled RoIs: ``dtype``, or float32 with ``quant``, whose first
    ``ActQuant`` observes and quantizes the float32 values.
    """

    def __init__(self, in_channels: int, channels: int = 512, n_convs: int = 8,
                 quant: str | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = partial(Conv2d if quant is None else partial(QuantConv, mode=quant), dtype=dtype)
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(str(2 * i), conv(in_channels if i == 0 else channels, channels,
                                             3, padding=1))
            self.add_module(str(2 * i + 1), nn.ReLU(inplace=True))
        self.quant = quant is not None
        if self.quant:
            self.kps_q = nn.ModuleList(ActQuant(quant) for _ in range(n_convs))
        self.input_dtype = torch.float32 if self.quant else dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            conv, relu = getattr(self, str(2 * i)), getattr(self, str(2 * i + 1))
            x = relu(conv(*self.kps_q[i](x)) if self.quant else conv(x))
        return x


def _upsample2x_transpose(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The adjoint of a 2x linear upsample (``align_corners=False``) along
    ``dim`` (counted from the end, negative): output ``2i`` is ``x[i-1] / 4 + 3 x[i] / 4`` (``x[0]`` for
    ``i = 0``), output ``2i + 1`` is ``3 x[i] / 4 + x[i+1] / 4`` (``x[n-1]``
    for the last), so input ``j`` gathers ``3/4`` of outputs ``2j`` and
    ``2j + 1`` and ``1/4`` of outputs ``2j - 1`` and ``2j + 2``, each clamped
    output counting whole at the two ends. Elementwise, with no atomics."""
    e, o = g.unflatten(dim, (-1, 2)).unbind(dim)
    n = e.shape[dim]
    prev = torch.cat([e.narrow(dim, 0, 1), o.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([e.narrow(dim, 1, n - 1), o.narrow(dim, n - 1, 1)], dim)
    return 0.75 * (e + o) + 0.25 * (prev + nxt)


class _Upsample2x(torch.autograd.Function):
    """``F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)``
    whose backward is :func:`_upsample2x_transpose` along both axes. PyTorch's
    CUDA backward of the bilinear upsample adds with atomics, in an order that
    changes from run to run (ROADMAP fault 2); this one sums in a fixed order."""

    @staticmethod
    def forward(ctx, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _upsample2x_transpose(_upsample2x_transpose(g, -1), -2)


def upsample_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of NCHW ``x`` (``align_corners=False``, torch's
    ``interpolate`` and JAX's ``jax.image.resize``). On a CUDA tensor that
    needs a gradient, its backward is deterministic (:class:`_Upsample2x`);
    elsewhere it is ``F.interpolate`` itself."""
    if x.is_cuda and x.requires_grad:
        return _Upsample2x.apply(x)
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class KeypointPredictor(nn.Module):
    """Transposed conv (4, stride 2) then 2x bilinear upsample
    (``align_corners=False``, :func:`upsample_bilinear_2x`); NCHW in,
    ``(K, S, S, NK)`` NHWC heatmaps out."""

    def __init__(self, in_channels: int, num_keypoints: int):
        super().__init__()
        self.kps_score_lowres = ConvTranspose2d(in_channels, num_keypoints, 4, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_bilinear_2x(self.kps_score_lowres(x)).permute(0, 2, 3, 1)


def detection_candidates(class_logits: torch.Tensor, box_deltas: torch.Tensor,
                         proposals: torch.Tensor, prop_valid: torch.Tensor,
                         image_size: tuple[int, int], score_thresh: float = 0.05):
    """The foreground candidates that :func:`postprocess_detections_batch`
    picks from, ``K = N * (C - 1)`` an image in ``(proposal, class)`` order:
    ``(boxes (B, K, 4), labels (K,), scores (B, K), valid (B, K))``, valid
    where the proposal is, the decoded box is at least 0.01 wide and high and
    the softmax score is above ``score_thresh``."""
    B, N, C = class_logits.shape
    scores = torch.softmax(class_logits, dim=-1)
    boxes = clip_boxes(decode_boxes(box_deltas, proposals[:, :, None, :],
                                    BOX_CODER_WEIGHTS), image_size)
    fg_scores = scores[:, :, 1:].reshape(B, N * (C - 1))
    fg_boxes = boxes[:, :, 1:, :].reshape(B, N * (C - 1), 4)
    fg_labels = torch.arange(1, C, device=class_logits.device).repeat(N)
    fg_valid = prop_valid.repeat_interleave(C - 1, dim=1)
    w = fg_boxes[..., 2] - fg_boxes[..., 0]
    h = fg_boxes[..., 3] - fg_boxes[..., 1]
    fg_valid = fg_valid & (w >= 0.01) & (h >= 0.01) & (fg_scores > score_thresh)
    return fg_boxes, fg_labels, fg_scores, fg_valid


def postprocess_detections_batch(class_logits: torch.Tensor, box_deltas: torch.Tensor,
                                  proposals: torch.Tensor, prop_valid: torch.Tensor,
                                  image_size: tuple[int, int],
                                  score_thresh: float = 0.05, nms_thresh: float = 0.5,
                                  detections_per_img: int = 1):
    """Detections per image, the JAX device path: ``class_logits (B, N, C)``,
    ``box_deltas (B, N, C, 4)``, ``proposals (B, N, 4)``, ``prop_valid (B, N)``
    -> ``(boxes (B, D, 4), labels (B, D), scores (B, D), valid (B, D))`` for
    ``D = detections_per_img``.

    ``D == 1``: greedy NMS never suppresses the best box, so top-1 after NMS
    is the argmax over valid candidates (ties: lower index first), without
    NMS. Otherwise class-aware NMS over the ``N * (C - 1)`` candidates of
    each image as one K2 call of ``B`` groups: boxes shifted by
    ``label * (max(image_size) + 2)`` so that classes never suppress each
    other, a stable descending sort by score (invalid candidates last), the
    keep mask, then the top ``D`` kept scores (ties: lower index first);
    slots past the kept ones are invalid with score 0.
    """
    B, N, C = class_logits.shape
    fg_boxes, fg_labels, fg_scores, fg_valid = detection_candidates(
        class_logits, box_deltas, proposals, prop_valid, image_size, score_thresh)
    masked = torch.where(fg_valid, fg_scores, torch.full_like(fg_scores, float("-inf")))

    if detections_per_img == 1:
        top_i = torch.argmax(masked, dim=1, keepdim=True)
        top_s = torch.gather(masked, 1, top_i)
        out_boxes = torch.gather(fg_boxes, 1, top_i[..., None].expand(B, 1, 4))
        out_labels = fg_labels[top_i]
        out_valid = top_s > float("-inf")
        return out_boxes, out_labels, torch.where(out_valid, top_s, torch.zeros_like(top_s)), \
            out_valid

    max_coord = float(max(image_size)) + 2.0
    shifted = fg_boxes + (fg_labels.to(fg_boxes.dtype) * max_coord)[None, :, None]
    order = torch.argsort(-masked, dim=1, stable=True)
    idx4 = order[..., None].expand(B, N * (C - 1), 4)
    s_boxes = torch.gather(shifted, 1, idx4)          # fresh, contiguous, aligned
    s_raw = torch.gather(fg_boxes, 1, idx4)
    s_scores = torch.gather(fg_scores, 1, order)
    s_labels = fg_labels[order]
    s_valid = torch.gather(fg_valid, 1, order)
    keep = nms_keep_sorted_batch_cuda(s_boxes, s_valid, nms_thresh)   # kernel K2
    kept = torch.where(keep, s_scores, torch.full_like(s_scores, float("-inf")))
    top_s, top_i = _top_k(kept, detections_per_img)
    out_boxes = torch.gather(s_raw, 1, top_i[..., None].expand(B, detections_per_img, 4))
    out_labels = torch.gather(s_labels, 1, top_i)
    out_valid = top_s > float("-inf")
    return out_boxes, out_labels, torch.where(out_valid, top_s, torch.zeros_like(top_s)), \
        out_valid


def _bicubic_kernel(t: float, a: float = -0.75) -> float:
    t = abs(t)
    if t <= 1.0:
        return (a + 2.0) * t ** 3 - (a + 3.0) * t ** 2 + 1.0
    if t < 2.0:
        return a * t ** 3 - 5.0 * a * t ** 2 + 8.0 * a * t - 4.0 * a
    return 0.0


def _local_bicubic_matrix(upsample: int, cells: int) -> np.ndarray:
    """``(u * cells, cells + 4)``: weight of padded-window row ``j`` for output
    row ``i`` of a cell-aligned window (torch bicubic, ``align_corners=False``)."""
    taps = cells + 4
    Wn = upsample * cells
    U = np.zeros((Wn, taps), np.float32)
    for i in range(Wn):
        src = (i + 0.5) / upsample - 0.5 + 2.0
        t0 = int(np.floor(src))
        f = src - t0
        for m in range(4):
            U[i, t0 - 1 + m] += _bicubic_kernel(f + 1.0 - m)
    return U


def heatmaps_to_keypoints(kp_logits: torch.Tensor, boxes: torch.Tensor,
                          upsample: int = 4):
    """Decode ``(K, S, S, NK)`` heatmaps to image-space keypoints ``(K, NK, 3)``
    and scores ``(K, NK)``, the JAX package's windowed bicubic decode.

    Pass 1 takes the nearest-cell argmax on the ``S x S`` grid; pass 2 evaluates
    the bicubic ``(u*S)^2`` upsample (a = -0.75, ``align_corners=False``, border
    replicate) on a 8-cell window around it and takes its argmax; then
    ``x = (x_int + 0.5) * w / (u*S) + x1``.
    """
    K, S, _, NK = kp_logits.shape
    u = upsample
    Su = u * S
    cells = min(8, S)
    taps = cells + 4
    Wn = u * cells
    dev = kp_logits.device
    maps = kp_logits.float().permute(0, 3, 1, 2).reshape(K * NK, S, S)

    idx_c = torch.argmax(maps.reshape(K * NK, S * S), dim=-1)
    cy, cx = idx_c // S, idx_c % S
    wy0 = (cy - cells // 2).clamp(0, S - cells)
    wx0 = (cx - cells // 2).clamp(0, S - cells)

    padded = F.pad(maps[:, None], (2, 2, 2, 2), mode="replicate")[:, 0]
    r = torch.arange(taps, device=dev)
    rows = (wy0[:, None] + r[None, :])[:, :, None]
    cols = (wx0[:, None] + r[None, :])[:, None, :]
    win = padded[torch.arange(K * NK, device=dev)[:, None, None], rows, cols]
    U = torch.from_numpy(_local_bicubic_matrix(u, cells)).to(dev)
    up = U @ win @ U.T                                  # (K*NK, Wn, Wn)
    flat = up.reshape(K, NK, Wn * Wn)
    score, idx = flat.max(dim=-1)
    yy = (idx // Wn + u * wy0.reshape(K, NK)).float()
    xx = (idx % Wn + u * wx0.reshape(K, NK)).float()

    x1, y1 = boxes[:, 0:1], boxes[:, 1:2]
    w = (boxes[:, 2:3] - boxes[:, 0:1]).clamp(min=1e-6)
    h = (boxes[:, 3:4] - boxes[:, 1:2]).clamp(min=1e-6)
    x = (xx + 0.5) * w / Su + x1
    y = (yy + 0.5) * h / Su + y1
    return torch.stack([x, y, torch.ones_like(score)], dim=-1), score


def select_training_samples(proposals: torch.Tensor, prop_valid: torch.Tensor,
                            gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                            gt_valid: torch.Tensor, noise: torch.Tensor,
                            num_samples: int = 512, positive_fraction: float = 0.25,
                            fg_iou_thresh: float = 0.5, bg_iou_thresh: float = 0.5):
    """Box-head sampling per image, batched: GT boxes are appended to the
    ``(B, S0, 4)`` proposals (torchvision ``add_gt_proposals``), matched,
    sampled with ``noise (B, S0 + G)``, and the sampled set is moved to the
    first ``num_samples`` slots. Returns ``(boxes, cls, gt_idx, valid, fg)``,
    each ``(B, num_samples, ...)``.

    The slot order is the JAX package's: a stable argsort of
    ``-sampled - arange(n) * 1e-9`` in float32. The 1e-9 steps fall below
    float32 resolution at 1.0, so the sampled entries come in runs of equal
    keys, higher index runs first and ascending inside a run; the expression
    and the stable sort are copied so that the order, not only the set, agrees.
    """
    all_boxes = torch.cat([proposals, gt_boxes], dim=1)
    all_valid = torch.cat([prop_valid, gt_valid], dim=1)
    iou = batched_iou(all_boxes, gt_boxes)
    iou = torch.where(gt_valid[:, None, :] & all_valid[:, :, None], iou,
                      torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.max(dim=2)
    is_fg = (best_iou >= fg_iou_thresh) & all_valid
    is_bg = (best_iou < bg_iou_thresh) & all_valid
    match_labels = torch.where(is_fg, 1, torch.where(is_bg, 0, -1))
    sampled = sample_balanced(match_labels, noise, num_samples, positive_fraction)
    n = sampled.shape[1]
    key = -sampled - torch.arange(n, dtype=torch.float32, device=sampled.device) * 1e-9
    take = torch.argsort(key, dim=1, stable=True)[:, :num_samples]

    boxes = torch.gather(all_boxes, 1, take[..., None].expand(*take.shape, 4))
    valid = torch.gather(sampled, 1, take) > 0
    fg = torch.gather(is_fg, 1, take) & valid
    gt_idx = torch.gather(best_gt, 1, take)
    cls = torch.where(fg, torch.gather(gt_labels, 1, gt_idx), 0)
    return boxes, cls, gt_idx, valid, fg


def fastrcnn_loss(class_logits: torch.Tensor, box_deltas: torch.Tensor,
                  sampled_boxes: torch.Tensor, cls_targets: torch.Tensor,
                  matched_gt_boxes: torch.Tensor, valid: torch.Tensor,
                  fg: torch.Tensor) -> dict[str, torch.Tensor]:
    """torchvision ``fastrcnn_loss`` over ``K`` flattened samples: cross entropy
    over the valid ones, smooth-L1 of the target class's deltas over the fg ones,
    summed and divided by the valid count (of the whole batch, over the
    ranks, in a data-parallel step)."""
    n = parallel.global_sum(valid.sum()).clamp(min=1).float() / parallel.shards()
    cls_loss = cross_entropy(class_logits, cls_targets, weights=valid.float())
    targets = encode_boxes(matched_gt_boxes, sampled_boxes, BOX_CODER_WEIGHTS)
    idx = cls_targets.long()[:, None, None].expand(-1, 1, 4)
    per_class = torch.gather(box_deltas, 1, idx)[:, 0]
    reg = smooth_l1(per_class, targets).sum(-1)
    return {"loss_classifier": cls_loss, "loss_box_reg": (reg * fg.float()).sum() / n}


def keypoints_to_heatmap_targets(keypoints: torch.Tensor, boxes: torch.Tensor,
                                 heatmap_size: int = 56):
    """``(K, NK, 3)`` (x, y, visibility) keypoints -> flat heatmap cell index
    ``(K, NK)`` int64 and validity (visible and inside the box), torchvision
    ``keypoints_to_heatmap``; points on the far edge snap inside."""
    x1, y1 = boxes[:, 0:1], boxes[:, 1:2]
    w = (boxes[:, 2:3] - boxes[:, 0:1]).clamp(min=1e-6)
    h = (boxes[:, 3:4] - boxes[:, 1:2]).clamp(min=1e-6)
    kx, ky = keypoints[..., 0], keypoints[..., 1]
    x = torch.floor((kx - x1) * (heatmap_size / w)).long().clamp(0, heatmap_size - 1)
    y = torch.floor((ky - y1) * (heatmap_size / h)).long().clamp(0, heatmap_size - 1)
    in_box = (kx >= x1) & (kx < x1 + w) & (ky >= y1) & (ky < y1 + h)
    return y * heatmap_size + x, (keypoints[..., 2] > 0) & in_box


def keypointrcnn_loss(kp_logits: torch.Tensor, kp_targets: torch.Tensor,
                      kp_valid: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """Cross entropy over the ``S x S`` positions per visible keypoint of each
    fg sample, over their count (of the whole batch in a data-parallel step,
    through ``cross_entropy``'s weights); ``kp_logits (K, S, S, NK)``."""
    K, S, _, NK = kp_logits.shape
    flat = kp_logits.permute(0, 3, 1, 2).reshape(K * NK, S * S)
    weights = (kp_valid & fg[:, None]).float().reshape(K * NK)
    return cross_entropy(flat, kp_targets.reshape(K * NK), weights=weights)


def _axis_interp_weights(starts: torch.Tensor, bins: torch.Tensor, n: int, size: int,
                         s: int = 2) -> torch.Tensor:
    """One axis of RoIAlign (``sampling_ratio=s``, ``aligned=False``) as a
    ``(K, size, n)`` matrix, the JAX ``_axis_interp_weights``: sample
    positions ``start + (i + (p + 0.5) / s) * bin``; a position at or below
    -1 or at or past ``n`` weighs nothing; the others are clipped to ``[0,
    n - 1]`` and weigh ``max(0, 1 - |pos - cell|)`` on each cell; the ``s``
    samples of a bin are averaged."""
    dev = starts.device
    grid = (torch.arange(size, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(s, dtype=torch.float32, device=dev)[None, :] + 0.5) / s
            ).reshape(-1)
    pos = starts[:, None] + grid[None, :] * bins[:, None]              # (K, size * s)
    oob = (pos <= -1.0) | (pos >= n)
    pos = pos.clamp(0.0, n - 1.0)
    cells = torch.arange(n, dtype=torch.float32, device=dev)
    w = (1.0 - (pos[..., None] - cells).abs()).clamp(min=0.0)          # (K, size * s, n)
    w = torch.where(oob[..., None], torch.zeros_like(w), w)
    return w.reshape(starts.shape[0], size, s, n).mean(dim=2)


@torch.no_grad()
def project_masks_on_boxes(gt_masks: torch.Tensor, boxes: torch.Tensor,
                           matched_idx: torch.Tensor, size: int = 28) -> torch.Tensor:
    """Each box's matched ground-truth mask cropped and resized to ``size x
    size`` (torchvision's ``roi_align`` of the full-size mask against its own
    box, ``sampling_ratio=2``, ``aligned=False``), batched: ``gt_masks (B, G,
    H, W)``, ``boxes (B, P, 4)``, ``matched_idx (B, P)`` -> ``(B, P, size,
    size)`` float32. Bilinear sampling is linear in the mask and separable,
    so it is two batched products with the per-axis matrices of
    :func:`_axis_interp_weights`, ``R_y @ M @ R_x^T``, as in JAX; the matched
    mask is gathered where JAX multiplies by a one-hot (both exact). A box
    narrower or lower than 1 is taken as 1 wide or high."""
    B, G, H, W = gt_masks.shape
    P = boxes.shape[1]
    flat = boxes.reshape(B * P, 4).float()
    x1, y1, x2, y2 = flat.unbind(-1)
    roi_w = (x2 - x1).clamp(min=1.0)
    roi_h = (y2 - y1).clamp(min=1.0)
    ry = _axis_interp_weights(y1, roi_h / size, H, size)                # (K, size, H)
    rx = _axis_interp_weights(x1, roi_w / size, W, size)                # (K, size, W)
    img = torch.arange(B, device=boxes.device).repeat_interleave(P)
    masks = gt_masks.float()[img, matched_idx.reshape(-1).long()]       # (K, H, W)
    out = torch.bmm(torch.bmm(ry, masks), rx.transpose(1, 2))
    return out.reshape(B, P, size, size)


def maskrcnn_loss(mask_logits: torch.Tensor, cls_targets: torch.Tensor,
                  mask_targets: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """Sigmoid cross entropy of the target class's ``S x S`` mask logits
    (``mask_logits (K, S, S, C)``) against the targets cut at 0.5, averaged
    over each RoI's pixels, summed over the fg RoIs and divided by their
    count (at least 1; of the whole batch, over the ranks, in a
    data-parallel step)."""
    K, S, _, _ = mask_logits.shape
    idx = cls_targets.long().reshape(K, 1, 1, 1).expand(K, S, S, 1)
    per_class = torch.gather(mask_logits, 3, idx)[..., 0]
    bce = optax_sigmoid_ce(per_class, (mask_targets > 0.5).float())
    per_roi = bce.mean(dim=(1, 2))
    n_fg = parallel.global_sum(fg.sum()).clamp(min=1).float() / parallel.shards()
    return (per_roi * fg.float()).sum() / n_fg
