"""Keypoint and Mask R-CNN (counterpart of the JAX ``models/rcnn.py``).

``forward(images)`` takes a fixed ``(B, H, W, 3)`` NHWC float batch (no resize
or normalisation, as the JAX model) and returns padded detections with
validity masks: ``boxes (B, D, 4)``, ``labels``, ``scores``, ``valid``,
``keypoints (B, D, NK, 3)``, ``keypoints_scores``, or ``masks (B, D, 28, 28)``
(the sigmoid of each detection's own label's mask logits). With ``targets`` it returns
the training loss dict of the JAX ``_forward_train``: RPN loss, proposals at
the training budgets, box sampling and loss, and the mask or keypoint head on
the positive budget (the mask targets in ``targets["masks"] (B, G, H, W)``). Inside it runs NCHW. Two detectors: the ResNet-50-FPN one
(4 pooled levels, p2..p5) and the MobileNetV3-Large one (2 pooled levels,
p4 and p5, 15 anchors a location), the JAX package's default serving
detector; and the ResNet-50-FPN Mask R-CNN (body detector, 3 detections an
image). The alternate families of the JAX package have their factories too:
the Swin-T and ConvNeXt-T keypoint R-CNNs (4 pooled levels), the box-only
ResNet-50-FPN Faster R-CNN (100 detections), and the box-only MobileNetV3-Large
and ConvNeXt-T ones over p4 and p5. The RPN's NMS is kernel K2, as is the box
NMS when more than one detection is kept; the RoIAligns (box 7x7, keypoint and mask 14x14) run
forward through kernel K3 and, in training, backward through kernel K4
(``MultilevelRoIAlign``), each in its bfloat16 instance when the levels are
bfloat16, pooling into bfloat16 where the head that reads the pooled values
computes in it (``_roi_align``); their wrappers take the plain versions only
for CPU tensors.

The two samplers take uniform noise, ``sampler_noise = {"rpn": (B, N_anchors),
"box": (B, rpn_post_nms_top_n_train + G)}``, or draw it from ``generator``
(on the generator's device, then moved to the images'), so that runs on two
devices, or against the JAX package, can share the same samples. Inside a
data-parallel step (``parallel.data_parallel``) the generator's draw is that
of the whole global batch, and each rank takes its own rows of it, so that the
ranks sample what one rank on the whole batch samples.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import parallel
from ..ops.anchors import multilevel_anchors
from ..ops.roi_align import multilevel_roi_align_diff
from . import roi_heads as rh
from .fpn import BackboneWithFPN
from .convnext import ConvNeXt
from .mobilenet_v3 import MobileNetV3Large
from .resnet import ResNet
from .rpn import RPN, generate_proposals, level_sizes, rpn_loss
from .swin import SwinTransformer


# the two keypoint detectors (JAX ``PFR_KEYPOINT_ARCH`` values)
KEYPOINT_ARCHS = ("resnet50", "mobile")


@dataclasses.dataclass(frozen=True)
class RCNNConfig:
    """Hyper-parameters (torchvision defaults unless noted), the JAX
    ``RCNNConfig``'s fields. ``box_detections_per_img`` defaults to the JAX
    config's 100; every factory passes its own."""

    num_classes: int = 2
    anchor_sizes: tuple = ((32,), (64,), (128,), (256,), (512,))
    aspect_ratios: tuple = (0.5, 1.0, 2.0)
    # RPN
    rpn_pre_nms_top_n_train: int = 2000
    rpn_pre_nms_top_n_test: int = 1000
    rpn_post_nms_top_n_train: int = 2000
    rpn_post_nms_top_n_test: int = 1000
    rpn_nms_thresh: float = 0.7
    # the RPN matcher's IoU thresholds are fixed at 0.7 / 0.3, as the JAX
    # ``rpn_loss`` fixes them (its config's fields are never read)
    rpn_batch_size_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    # box head
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    box_detections_per_img: int = 100
    box_fg_iou_thresh: float = 0.5
    box_bg_iou_thresh: float = 0.5
    box_batch_size_per_image: int = 512
    box_positive_fraction: float = 0.25
    # task heads
    with_mask: bool = False
    num_keypoints: int = 0
    mask_roi_size: int = 14
    keypoint_roi_size: int = 14
    # training: the keypoint head runs on the sampled-positive budget only
    task_heads_on_positives_only: bool = True


class RoIHeads(nn.Module):
    """Box, mask and keypoint heads under torchvision's ``roi_heads.*`` names,
    computing in ``dtype`` but where JAX pins float32 (the predictors)."""

    def __init__(self, cfg: RCNNConfig, channels: int, quant_kp: str | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.box_head = rh.TwoMLPHead(channels * 7 * 7, dtype=dtype)
        self.box_predictor = rh.FastRCNNPredictor(1024, cfg.num_classes)
        if cfg.with_mask:
            self.mask_head = rh.MaskHead(channels, dtype=dtype)
            self.mask_predictor = rh.MaskPredictor(256, cfg.num_classes, dtype=dtype)
        if cfg.num_keypoints:
            self.keypoint_head = rh.KeypointHead(channels, quant=quant_kp, dtype=dtype)
            self.keypoint_predictor = rh.KeypointPredictor(512, cfg.num_keypoints)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx, 1)`` for ``x (B, N, ...)`` and ``idx (B, M)``."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *(1,) * (x.dim() - 2))
                        .expand(*idx.shape, *x.shape[2:]))


class GeneralizedRCNN(nn.Module):
    """Backbone + FPN, RPN and RoI heads; see the module docstring.

    ``quant`` (``None``, ``"calibrate"`` or ``"int8"``) quantizes the RPN's
    shared conv, ``quant_kp`` the keypoint head's eight convolutions; the
    backbone carries its own flags (JAX ``GeneralizedRCNN(quant, quant_kp)``).
    ``dtype`` is the compute dtype of the RPN and the RoI heads (JAX
    ``GeneralizedRCNN.dtype``); the backbone carries its own. With bfloat16
    levels the RoIAligns run K3's bfloat16 instance forward and K4's backward
    in training.
    """

    def __init__(self, backbone: BackboneWithFPN, cfg: RCNNConfig, quant: str | None = None,
                 quant_kp: str | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.backbone = backbone
        self.dtype = dtype
        self.num_anchors = len(cfg.anchor_sizes[0]) * len(cfg.aspect_ratios)
        # the RPN sees every pyramid level: the FPN's and the max-pool one
        self.rpn = RPN(backbone.out_channels, self.num_anchors, quant,
                       num_levels=len(backbone.fpn.in_levels) + 1, dtype=dtype)
        self.roi_heads = RoIHeads(cfg, backbone.out_channels, quant_kp, dtype)

    def _roi_align(self, pool, strides, boxes_flat, batch_idx, output_size,
                   head: nn.Module | None = None):
        """RoIAlign over the pooled levels ``pool = (names, NHWC maps)``; the
        level range comes from their names (``p4``, ``p5`` -> 4..5), as the
        JAX ``_roi_align`` reads it, so the canonical mapper clamps to it.
        The pooled values are float32, as JAX's, or bfloat16 where the levels
        and ``head.input_dtype`` (the type in which the head that reads them
        computes) are: that head would round them to bfloat16 first thing, so
        nothing downstream changes by a bit, forward or backward."""
        names, feats = pool
        levels = [int(n[1:]) for n in names]
        bf16 = torch.bfloat16
        out_dtype = (bf16 if head is not None and head.input_dtype == bf16
                     and feats[0].dtype == bf16 else torch.float32)
        return multilevel_roi_align_diff(
            feats, boxes_flat.contiguous(), batch_idx, output_size,
            tuple(strides[: len(feats)]), min_level=min(levels), max_level=max(levels),
            out_dtype=out_dtype)

    def forward(self, images: torch.Tensor, targets: dict | None = None,
                sampler_noise: dict | None = None,
                generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        c = self.cfg
        B, H, W, _ = images.shape
        feats = self.backbone(images.permute(0, 3, 1, 2))
        names = sorted(feats, key=lambda n: int(n[1:]))        # p2..p6
        sizes = [tuple(feats[n].shape[2:]) for n in names]
        strides = [H // h for h, _ in sizes]
        anchors = multilevel_anchors(sizes, strides, c.anchor_sizes, c.aspect_ratios,
                                     device=images.device)
        objectness, deltas = self.rpn([feats[n] for n in names])
        # RoIs pool from every level but the max-pool one, which feeds the RPN
        # alone: p2..p5 (ResNet-50), p4..p5 (MobileNetV3)
        pool = (names[:-1], [feats[n].permute(0, 2, 3, 1).contiguous()
                             for n in names[:-1]])
        counts = level_sizes(sizes, self.num_anchors)
        if targets is not None:
            return self._forward_train(targets, sampler_noise, generator, pool,
                                       strides, anchors, counts, objectness, deltas,
                                       (H, W))
        return self._forward_eval(pool, strides, anchors, counts, objectness,
                                  deltas, (H, W))

    def draw_sampler_noise(self, B: int, n_anchors: int, n_gt: int,
                      generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Uniform noise for both samplers, drawn from ``generator``."""
        n_box = self.cfg.rpn_post_nms_top_n_train + n_gt
        return {"rpn": torch.rand(B, n_anchors, generator=generator, device=generator.device),
                "box": torch.rand(B, n_box, generator=generator, device=generator.device)}

    def _forward_train(self, targets, sampler_noise, generator, pool, strides,
                       anchors, counts, objectness, deltas, image_size):
        c = self.cfg
        B = objectness.shape[0]
        dev = objectness.device
        if sampler_noise is None:
            if generator is None:
                raise ValueError("training needs sampler_noise or a torch.Generator")
            mesh = parallel.active_mesh()
            n = 1 if mesh is None else mesh.size
            sampler_noise = self.draw_sampler_noise(B * n, anchors.shape[0],
                                                    targets["boxes"].shape[1], generator)
            if mesh is not None:
                sampler_noise = {k: v[mesh.rows(B * n)] for k, v in sampler_noise.items()}
        noise = {k: v.to(dev) for k, v in sampler_noise.items()}
        losses = rpn_loss(objectness, deltas, anchors, targets["boxes"], targets["valid"],
                          noise["rpn"], c.rpn_batch_size_per_image,
                          c.rpn_positive_fraction)
        proposals, prop_valid = generate_proposals(
            objectness.detach(), deltas.detach(), anchors, counts, image_size,
            c.rpn_pre_nms_top_n_train, c.rpn_post_nms_top_n_train, c.rpn_nms_thresh)
        boxes, cls_t, gt_idx, valid, fg = rh.select_training_samples(
            proposals, prop_valid, targets["boxes"], targets["labels"], targets["valid"],
            noise["box"], c.box_batch_size_per_image, c.box_positive_fraction,
            c.box_fg_iou_thresh, c.box_bg_iou_thresh)

        S = boxes.shape[1]
        boxes_flat = boxes.reshape(B * S, 4)
        batch_idx = torch.arange(B, dtype=torch.int32, device=dev)
        heads = self.roi_heads
        pooled = self._roi_align(pool, strides, boxes_flat,
                                 batch_idx.repeat_interleave(S), (7, 7), heads.box_head)
        class_logits, box_deltas = heads.box_predictor(heads.box_head(pooled))
        matched = _take(targets["boxes"], gt_idx).reshape(B * S, 4)
        losses.update(rh.fastrcnn_loss(class_logits, box_deltas, boxes_flat,
                                       cls_t.reshape(-1), matched, valid.reshape(-1),
                                       fg.reshape(-1)))

        if c.with_mask or c.num_keypoints:
            P = S
            if c.task_heads_on_positives_only:
                # the sampler never emits more positives than this budget, so
                # the subset holds every fg sample and the loss is unchanged
                P = min(max(1, int(c.box_batch_size_per_image * c.box_positive_fraction)), S)
            # stable fg-first order keeps the sampler's order
            pos_order = torch.argsort((~fg).to(torch.uint8), dim=1, stable=True)[:, :P]
            pos_boxes = _take(boxes, pos_order)
            pos_boxes_flat = pos_boxes.reshape(B * P, 4)
            pos_gt_idx = _take(gt_idx, pos_order)
            pos_fg = _take(fg, pos_order).reshape(-1)
            pos_cls = _take(cls_t, pos_order).reshape(-1)
            pos_bidx = batch_idx.repeat_interleave(P)

        if c.with_mask:
            r = c.mask_roi_size
            pooled = self._roi_align(pool, strides, pos_boxes_flat, pos_bidx, (r, r),
                                     heads.mask_head)
            mask_logits = heads.mask_predictor(heads.mask_head(pooled.permute(0, 3, 1, 2)))
            S_m = mask_logits.shape[1]
            gt_masks = rh.project_masks_on_boxes(targets["masks"], pos_boxes, pos_gt_idx, S_m)
            losses["loss_mask"] = rh.maskrcnn_loss(mask_logits, pos_cls,
                                                   gt_masks.reshape(B * P, S_m, S_m), pos_fg)

        if c.num_keypoints:
            r = c.keypoint_roi_size
            pooled = self._roi_align(pool, strides, pos_boxes_flat, pos_bidx, (r, r),
                                     heads.keypoint_head)
            kp_logits = heads.keypoint_predictor(heads.keypoint_head(pooled.permute(0, 3, 1, 2)))
            gt_kps = _take(targets["keypoints"], pos_gt_idx)
            kp_targets, kp_valid = rh.keypoints_to_heatmap_targets(
                gt_kps.reshape(B * P, c.num_keypoints, 3), pos_boxes_flat, kp_logits.shape[1])
            losses["loss_keypoint"] = rh.keypointrcnn_loss(kp_logits, kp_targets,
                                                           kp_valid, pos_fg)
        return losses

    def _forward_eval(self, pool, strides, anchors, counts, objectness, deltas,
                      image_size):
        c = self.cfg
        B = objectness.shape[0]
        proposals, prop_valid = generate_proposals(
            objectness, deltas, anchors, counts, image_size, c.rpn_pre_nms_top_n_test,
            c.rpn_post_nms_top_n_test, c.rpn_nms_thresh)
        S = proposals.shape[1]
        batch_idx = torch.arange(B, dtype=torch.int32, device=objectness.device)
        heads = self.roi_heads
        pooled = self._roi_align(pool, strides, proposals.reshape(B * S, 4),
                                 batch_idx.repeat_interleave(S), (7, 7), heads.box_head)
        class_logits, box_deltas = heads.box_predictor(heads.box_head(pooled))
        boxes, labels, scores, valid = rh.postprocess_detections_batch(
            class_logits.reshape(B, S, -1), box_deltas.reshape(B, S, -1, 4),
            proposals, prop_valid, image_size, c.box_score_thresh, c.box_nms_thresh,
            c.box_detections_per_img)
        out = {"boxes": boxes, "labels": labels, "scores": scores, "valid": valid}

        D = boxes.shape[1]
        det_flat = boxes.reshape(B * D, 4)
        det_bidx = batch_idx.repeat_interleave(D)
        if c.with_mask:
            r = c.mask_roi_size
            pooled = self._roi_align(pool, strides, det_flat, det_bidx, (r, r), heads.mask_head)
            logits = heads.mask_predictor(heads.mask_head(pooled.permute(0, 3, 1, 2)))
            own = torch.gather(logits, 3, labels.reshape(B * D, 1, 1, 1).expand(
                B * D, *logits.shape[1:3], 1))[..., 0]
            out["masks"] = torch.sigmoid(own).reshape(B, D, *own.shape[1:])
        if c.num_keypoints:
            r = c.keypoint_roi_size
            pooled = self._roi_align(pool, strides, det_flat, det_bidx, (r, r),
                                     heads.keypoint_head)
            kp_logits = heads.keypoint_predictor(
                heads.keypoint_head(pooled.permute(0, 3, 1, 2)))
            kps, kp_scores = rh.heatmaps_to_keypoints(kp_logits, det_flat)
            out["keypoints"] = kps.reshape(B, D, c.num_keypoints, 3)
            out["keypoints_scores"] = kp_scores.reshape(B, D, c.num_keypoints)
        return out


QUANT_SCOPES = ("trunk", "fpn", "rpn", "full")


def _quant_trunk(stage_sizes, quant: str | None, quant_scope: str,
                 dtype: torch.dtype = torch.float32):
    """The ResNet-50-FPN backbone with int8 twins per ``quant_scope`` (JAX
    ``rcnn.py``): the trunk always, the FPN for ``fpn`` and ``full``; returns
    ``(backbone, the RPN's quant)``, the RPN quantized for ``rpn`` and
    ``full``. Trunk and FPN compute in ``dtype``."""
    if quant_scope not in QUANT_SCOPES:
        raise ValueError(f"quant_scope {quant_scope!r}: expected one of {QUANT_SCOPES}")
    body = ResNet(stage_sizes=stage_sizes, features_only=True, quant=quant, dtype=dtype)
    backbone = BackboneWithFPN(body, quant=quant if quant_scope in ("fpn", "full") else None,
                               dtype=dtype)
    return backbone, quant if quant_scope in ("rpn", "full") else None


def maskrcnn_resnet50_fpn(num_classes: int = 2, box_detections_per_img: int = 3,
                          stage_sizes: tuple[int, ...] = (3, 4, 6, 3), quant=None,
                          quant_scope: str = "rpn", dtype: torch.dtype = torch.float32,
                          **overrides) -> GeneralizedRCNN:
    """The production body detector and segmenter: ResNet-50-FPN Mask R-CNN
    with a frozen-BN trunk, 2 classes, 3 detections an image (JAX
    ``maskrcnn_resnet50_fpn``). ``stage_sizes`` cuts depth for tests;
    ``overrides`` set :class:`RCNNConfig` fields. ``quant`` (``"calibrate"``
    or ``"int8"``) with ``quant_scope`` (``trunk``, ``fpn``, ``rpn`` (the
    default, the shipping scope) or ``full``) builds the int8 serving twin.
    ``dtype`` is the compute dtype of trunk, FPN, RPN and heads (the JAX
    model ``clone(dtype=...)`` at all three levels)."""
    cfg = RCNNConfig(num_classes=num_classes, with_mask=True,
                     box_detections_per_img=box_detections_per_img, **overrides)
    backbone, rpn_quant = _quant_trunk(stage_sizes, quant, quant_scope, dtype)
    return GeneralizedRCNN(backbone, cfg, quant=rpn_quant, dtype=dtype)


def keypointrcnn_resnet50_fpn(num_classes: int = 2, num_keypoints: int = 3,
                              stage_sizes: tuple[int, ...] = (3, 4, 6, 3), quant=None,
                              quant_scope: str = "rpn", quant_kp=None,
                              dtype: torch.dtype = torch.float32,
                              **overrides) -> GeneralizedRCNN:
    """The production head+landmark detector: ResNet-50-FPN keypoint R-CNN with
    a frozen-BN trunk, 3 keypoints, 1 detection per image. ``stage_sizes`` cuts
    depth for tests; ``overrides`` set :class:`RCNNConfig` fields. ``quant``
    and ``quant_scope`` as for :func:`maskrcnn_resnet50_fpn`; ``quant_kp``
    quantizes the keypoint head's convolutions (an independent knob).
    ``dtype`` is the compute dtype of every part, as for
    :func:`maskrcnn_resnet50_fpn`."""
    cfg = RCNNConfig(num_classes=num_classes, num_keypoints=num_keypoints,
                     box_detections_per_img=1, **overrides)
    backbone, rpn_quant = _quant_trunk(stage_sizes, quant, quant_scope, dtype)
    return GeneralizedRCNN(backbone, cfg, quant=rpn_quant, quant_kp=quant_kp, dtype=dtype)


def mobile_net_v3_large_keypoint_rcnn(frozen_stats: bool = True, bn_momentum: float = 0.99,
                                      quant_kp=None, dtype: torch.dtype = torch.float32,
                                      **overrides) -> GeneralizedRCNN:
    """MobileNetV3-Large keypoint R-CNN (JAX ``mobile_net_v3_large_keypoint_rcnn``):
    a 2-level FPN over ``c4``/``c5`` (p4, p5 and a max-pool p6), anchor sizes
    ``(32, 64, 128, 256, 512)`` on every level with ratios ``(0.5, 1, 2)`` (15
    anchors a location), 3 keypoints, 1 detection. ``frozen_stats`` picks the
    trunk's norm: frozen statistics (serving), or live BatchNorm with flax
    momentum ``bn_momentum`` (the keypoint config trains with
    ``frozen_stats=False, bn_momentum=0.9``). ``overrides`` set
    :class:`RCNNConfig` fields. ``quant_kp`` (``"calibrate"`` or ``"int8"``)
    quantizes the keypoint head's convolutions; the MobileNetV3 trunk has no
    int8 path, as in JAX. ``dtype`` is the compute dtype of every part."""
    kw = dict(num_classes=2, num_keypoints=3, box_detections_per_img=1,
              anchor_sizes=((32, 64, 128, 256, 512),) * 3, aspect_ratios=(0.5, 1.0, 2.0))
    kw.update(overrides)
    body = MobileNetV3Large(features_only=True, frozen_stats=frozen_stats,
                            bn_momentum=bn_momentum, dtype=dtype)
    return GeneralizedRCNN(_fpn_over(body, ("c4", "c5"), dtype), RCNNConfig(**kw),
                           quant_kp=quant_kp, dtype=dtype)


def _fpn_over(body: nn.Module, in_levels: tuple[str, ...] = ("c2", "c3", "c4", "c5"),
              dtype: torch.dtype = torch.float32) -> BackboneWithFPN:
    """``BackboneWithFPN`` over a trunk's ``out_channels`` at ``in_levels``,
    its FPN in ``dtype``."""
    return BackboneWithFPN(body, tuple(body.out_channels[lvl] for lvl in in_levels), in_levels,
                           dtype=dtype)


# the 2-level box-only factories' anchors and budgets (JAX rcnn.py:525-568)
_P4_P5 = dict(num_classes=2, anchor_sizes=((32, 64, 128, 256, 512),) * 3,
              rpn_pre_nms_top_n_test=150, rpn_post_nms_top_n_test=150,
              box_detections_per_img=1)


def swin_tiny_keypoint_rcnn(num_classes: int = 2, num_keypoints: int = 3, window_size: int = 7,
                            dtype: torch.dtype = torch.float32,
                            **overrides) -> GeneralizedRCNN:
    """Swin-T keypoint R-CNN (JAX ``swin_tiny_keypoint_rcnn``): a 4-level FPN
    over the Swin stages (widths 96, 192, 384, 768), 1 detection. Its input's
    sides must be multiples of ``window_size x 32`` (224 at window 7).
    ``overrides`` set :class:`RCNNConfig` fields; ``dtype`` is the compute
    dtype of trunk, FPN and model, as JAX's ``clone(dtype=...)`` at the three
    levels builds them."""
    cfg = RCNNConfig(num_classes=num_classes, num_keypoints=num_keypoints,
                     box_detections_per_img=1, **overrides)
    body = SwinTransformer(hidden_dim=96, layers=(2, 2, 6, 2), heads=(3, 6, 12, 24),
                           window_size=window_size, features_only=True, dtype=dtype)
    return GeneralizedRCNN(_fpn_over(body, dtype=dtype), cfg, dtype=dtype)


def fasterrcnn_resnet50_fpn(num_classes: int = 2, dtype: torch.dtype = torch.float32,
                            **overrides) -> GeneralizedRCNN:
    """Box-only ResNet-50-FPN Faster R-CNN with a frozen-BN trunk at the JAX
    config's defaults (JAX ``fasterrcnn_resnet50_fpn``): 100 detections an
    image, so its box NMS runs through K2. Like JAX's ``top_k``, the box
    post-process raises unless the test proposals (times the foreground
    classes) number at least 100.
    ``overrides`` set :class:`RCNNConfig` fields; ``dtype`` is the compute
    dtype of every part."""
    body = ResNet(features_only=True, dtype=dtype)
    return GeneralizedRCNN(BackboneWithFPN(body, dtype=dtype),
                           RCNNConfig(num_classes=num_classes, **overrides), dtype=dtype)


def mobile_net_v3_large_rcnn(dtype: torch.dtype = torch.float32,
                             **overrides) -> GeneralizedRCNN:
    """Box-only MobileNetV3-Large Faster R-CNN (JAX ``mobile_net_v3_large_rcnn``):
    frozen statistics, a 2-level FPN over ``c4``/``c5`` and a max-pool p6,
    anchor sizes ``(32, 64, 128, 256, 512)`` on every level with ratios
    ``(0.5, 1, 2)``, 150/150 test proposals, 1 detection; ``dtype`` is the
    compute dtype of every part."""
    kw = dict(_P4_P5, aspect_ratios=(0.5, 1.0, 2.0))
    kw.update(overrides)
    body = MobileNetV3Large(features_only=True, frozen_stats=True, dtype=dtype)
    return GeneralizedRCNN(_fpn_over(body, ("c4", "c5"), dtype), RCNNConfig(**kw), dtype=dtype)


def convnetx_tiny_rcnn(dtype: torch.dtype = torch.float32, **overrides) -> GeneralizedRCNN:
    """Box-only ConvNeXt-T Faster R-CNN (JAX ``convnetx_tiny_rcnn``, the
    reference's typo kept): a 2-level FPN over ``c4``/``c5`` (384, 768), the
    anchors of :func:`mobile_net_v3_large_rcnn` with ratios ``(10/14, 1,
    14/10)``, 150/150 test proposals, 1 detection; ``dtype`` is the compute
    dtype of every part."""
    kw = dict(_P4_P5, aspect_ratios=(10 / 14, 1.0, 14 / 10))
    kw.update(overrides)
    body = ConvNeXt(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), features_only=True,
                    dtype=dtype)
    return GeneralizedRCNN(_fpn_over(body, ("c4", "c5"), dtype), RCNNConfig(**kw), dtype=dtype)


def convnext_tiny_keypoint_rcnn(dtype: torch.dtype = torch.float32,
                                **overrides) -> GeneralizedRCNN:
    """ConvNeXt-T keypoint R-CNN over the 4-level pyramid (JAX
    ``convnext_tiny_keypoint_rcnn``): 3 keypoints, 1 detection; ``dtype`` is
    the compute dtype of every part."""
    kw = dict(num_classes=2, num_keypoints=3, box_detections_per_img=1)
    kw.update(overrides)
    body = ConvNeXt(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), features_only=True,
                    dtype=dtype)
    return GeneralizedRCNN(_fpn_over(body, dtype=dtype), RCNNConfig(**kw), dtype=dtype)


def frozen_twin(model: GeneralizedRCNN) -> GeneralizedRCNN:
    """The serving twin of a live-BN MobileNetV3 detector: the same
    configuration with frozen statistics, holding ``model``'s weights and
    running statistics (a strict ``load_state_dict``), in eval mode without
    gradients, on ``model``'s device. The JAX package serves the live-BN
    training state the same way, rebuilt with ``frozen_stats=True``."""
    body = model.backbone.body
    if not isinstance(body, MobileNetV3Large):
        raise TypeError("frozen_twin: a MobileNetV3 detector is expected")
    twin = mobile_net_v3_large_keypoint_rcnn(frozen_stats=True, dtype=model.dtype,
                                             **dataclasses.asdict(model.cfg))
    twin.load_state_dict(model.state_dict(), strict=True)
    dev = next(model.parameters()).device
    return twin.eval().requires_grad_(False).to(dev)
