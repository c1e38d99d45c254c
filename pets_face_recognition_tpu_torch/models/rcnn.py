"""Keypoint R-CNN, eval path (counterpart of the JAX ``models/rcnn.py``).

``forward`` takes a fixed ``(B, H, W, 3)`` NHWC float batch (no resize or
normalisation, as the JAX model) and returns padded detections with validity
masks: ``boxes (B, D, 4)``, ``labels``, ``scores``, ``valid``, ``keypoints
(B, D, NK, 3)``, ``keypoints_scores``. Inside it runs NCHW. The RPN's NMS is
kernel K2 and both RoIAligns (box 7x7, keypoint 14x14) are kernel K3; their
wrappers fall back to the plain versions only for CPU tensors.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.anchors import multilevel_anchors
from ..ops.roi_align import multilevel_roi_align_cuda
from . import roi_heads as rh
from .fpn import BackboneWithFPN
from .resnet import ResNet
from .rpn import RPN, generate_proposals, level_sizes


@dataclasses.dataclass(frozen=True)
class RCNNConfig:
    """Eval hyper-parameters (torchvision defaults unless noted); the training
    fields of the JAX ``RCNNConfig`` wait for the training slice."""

    num_classes: int = 2
    anchor_sizes: tuple = ((32,), (64,), (128,), (256,), (512,))
    aspect_ratios: tuple = (0.5, 1.0, 2.0)
    rpn_pre_nms_top_n_test: int = 1000
    rpn_post_nms_top_n_test: int = 1000
    rpn_nms_thresh: float = 0.7
    box_score_thresh: float = 0.05
    box_detections_per_img: int = 1
    num_keypoints: int = 0
    keypoint_roi_size: int = 14


class RoIHeads(nn.Module):
    """Box and keypoint heads under torchvision's ``roi_heads.*`` names."""

    def __init__(self, cfg: RCNNConfig, channels: int):
        super().__init__()
        self.box_head = rh.TwoMLPHead(channels * 7 * 7)
        self.box_predictor = rh.FastRCNNPredictor(1024, cfg.num_classes)
        if cfg.num_keypoints:
            self.keypoint_head = rh.KeypointHead(channels)
            self.keypoint_predictor = rh.KeypointPredictor(512, cfg.num_keypoints)


class GeneralizedRCNN(nn.Module):
    """Backbone + FPN, RPN and RoI heads; see the module docstring."""

    def __init__(self, backbone: BackboneWithFPN, cfg: RCNNConfig):
        super().__init__()
        if cfg.box_detections_per_img != 1:
            raise NotImplementedError("only box_detections_per_img == 1 is ported")
        self.cfg = cfg
        self.backbone = backbone
        self.num_anchors = len(cfg.anchor_sizes[0]) * len(cfg.aspect_ratios)
        self.rpn = RPN(backbone.out_channels, self.num_anchors)
        self.roi_heads = RoIHeads(cfg, backbone.out_channels)

    def _roi_align(self, pool_feats, strides, boxes_flat, batch_idx, output_size):
        return multilevel_roi_align_cuda(
            pool_feats, boxes_flat.contiguous(), batch_idx, output_size,
            tuple(strides[: len(pool_feats)]), min_level=2,
            max_level=1 + len(pool_feats))

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        c = self.cfg
        B, H, W, _ = images.shape
        image_size = (H, W)
        feats = self.backbone(images.permute(0, 3, 1, 2))
        names = sorted(feats, key=lambda n: int(n[1:]))        # p2..p6
        sizes = [tuple(feats[n].shape[2:]) for n in names]
        strides = [H // h for h, _ in sizes]
        anchors = multilevel_anchors(sizes, strides, c.anchor_sizes, c.aspect_ratios,
                                     device=images.device)
        objectness, deltas = self.rpn([feats[n] for n in names])
        # RoIs pool from p2..p5 only (the max-pool level feeds the RPN alone)
        pool_feats = [feats[n].permute(0, 2, 3, 1).contiguous() for n in names[:-1]]

        proposals, prop_valid = generate_proposals(
            objectness, deltas, anchors, level_sizes(sizes, self.num_anchors),
            image_size, c.rpn_pre_nms_top_n_test, c.rpn_post_nms_top_n_test,
            c.rpn_nms_thresh)
        S = proposals.shape[1]
        batch_idx = torch.arange(B, dtype=torch.int32, device=images.device)
        pooled = self._roi_align(pool_feats, strides, proposals.reshape(B * S, 4),
                                 batch_idx.repeat_interleave(S), (7, 7))
        heads = self.roi_heads
        class_logits, box_deltas = heads.box_predictor(heads.box_head(pooled))
        boxes, labels, scores, valid = rh.postprocess_detections_batch(
            class_logits.reshape(B, S, -1), box_deltas.reshape(B, S, -1, 4),
            proposals, prop_valid, image_size, c.box_score_thresh)
        out = {"boxes": boxes, "labels": labels, "scores": scores, "valid": valid}

        if c.num_keypoints:
            D = boxes.shape[1]
            det_flat = boxes.reshape(B * D, 4)
            r = c.keypoint_roi_size
            pooled = self._roi_align(pool_feats, strides, det_flat,
                                     batch_idx.repeat_interleave(D), (r, r))
            kp_logits = heads.keypoint_predictor(
                heads.keypoint_head(pooled.permute(0, 3, 1, 2)))
            kps, kp_scores = rh.heatmaps_to_keypoints(kp_logits, det_flat)
            out["keypoints"] = kps.reshape(B, D, c.num_keypoints, 3)
            out["keypoints_scores"] = kp_scores.reshape(B, D, c.num_keypoints)
        return out


def keypointrcnn_resnet50_fpn(num_classes: int = 2, num_keypoints: int = 3,
                              stage_sizes: tuple[int, ...] = (3, 4, 6, 3),
                              **overrides) -> GeneralizedRCNN:
    """The production head+landmark detector: ResNet-50-FPN keypoint R-CNN with
    a frozen-BN trunk, 3 keypoints, 1 detection per image. ``stage_sizes`` cuts
    depth for tests; ``overrides`` set :class:`RCNNConfig` fields."""
    cfg = RCNNConfig(num_classes=num_classes, num_keypoints=num_keypoints,
                     box_detections_per_img=1, **overrides)
    body = ResNet(stage_sizes=stage_sizes, features_only=True)
    return GeneralizedRCNN(BackboneWithFPN(body), cfg)
