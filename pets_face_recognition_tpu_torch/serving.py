"""Serving: batched detect -> align -> embed (counterpart of the JAX ``serving.py``
``EmbeddingService._embed_impl`` and of ``bench.py::build_serving_models``).

One synchronous call per batch, no thread and no queue: ``embed_batch`` takes
uint8 NHWC images and a decode-ok mask and returns ``(B, 512)`` embeddings and
a ``(B,)`` validity mask. Validity follows the reference's assert-and-skip: the
top detection must score above ``score_thr`` and its landmarks, rounded to the
pixel grid, must be pairwise more than 5 px apart. Everything
runs in float32, with TF32 off inside ``embed_batch`` whatever the caller set. On a CUDA device the path goes through kernels K2 and K3 (in
the detector) and K1 (in ``align_crop``).
"""

from __future__ import annotations

import torch
from torch import nn

from .device import float32_matmuls, resolve_device
from .models.embedder import resnet50_embedder
from .models.rcnn import keypointrcnn_resnet50_fpn
from .ops.homography import align_crop
from .weights import init_random_

DEFAULT_BASE_PTS = ((70.0, 92.0), (154.0, 92.0), (112.0, 160.0))
CROP_SIZE = (224, 224)
MIN_LANDMARK_DISTANCE = 5.0
# serving RPN budgets: one pet head per image, so 128 pre-NMS / 16 post-NMS
# proposals per image lose nothing (the JAX serving default, bench.py)
RPN_PRE_NMS_TOP_N, RPN_POST_NMS_TOP_N = 128, 16


def build_serving_models(device: str | torch.device = "cuda", seed: int = 0,
                         ) -> tuple[nn.Module, nn.Module, torch.Tensor]:
    """The serving detector (ResNet-50-FPN keypoint R-CNN, 3 keypoints, 1
    detection per image, RPN budgets 128/16) and the ResNet-50 512-d embedder,
    with seeded random weights, in eval mode on ``device``. Returns
    ``(detector, embedder, base_pts (3, 2))``."""
    dev = resolve_device(device)
    detector = keypointrcnn_resnet50_fpn(
        num_classes=2, num_keypoints=3, rpn_pre_nms_top_n_test=RPN_PRE_NMS_TOP_N,
        rpn_post_nms_top_n_test=RPN_POST_NMS_TOP_N)
    embedder = resnet50_embedder(512)
    init_random_(detector, seed)
    init_random_(embedder, seed + 1)
    detector = detector.eval().requires_grad_(False).to(dev)
    embedder = embedder.eval().requires_grad_(False).to(dev)
    return detector, embedder, torch.tensor(DEFAULT_BASE_PTS, device=dev)


class EmbeddingService:
    """Synchronous head-embedding service over decoded uint8 image batches."""

    def __init__(self, detector: nn.Module, embedder: nn.Module,
                 base_pts: torch.Tensor | None = None, score_thr: float = 0.9,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.detector = detector
        self.embedder = embedder
        self.base_pts = torch.tensor(DEFAULT_BASE_PTS) if base_pts is None else base_pts
        self.base_pts = self.base_pts.to(self.device, torch.float32)
        self.score_thr = score_thr

    @torch.inference_mode()
    @float32_matmuls()
    def embed_batch(self, images_u8: torch.Tensor, ok: torch.Tensor):
        """``images_u8 (B, H, W, 3)`` uint8, ``ok (B,)`` bool ->
        ``(embeddings (B, 512) float32, valid (B,) bool)``."""
        imgs = images_u8.to(self.device).float() / 255.0
        dets = self.detector(imgs)
        det_ok = dets["valid"][:, 0] & (dets["scores"][:, 0] > self.score_thr)
        # the reference rounds landmarks to the pixel grid before the distance
        # check and the alignment
        kps = torch.round(dets["keypoints"][:, 0, :, :2])
        d01 = torch.linalg.norm(kps[:, 0] - kps[:, 1], dim=-1)
        d02 = torch.linalg.norm(kps[:, 0] - kps[:, 2], dim=-1)
        d12 = torch.linalg.norm(kps[:, 1] - kps[:, 2], dim=-1)
        kp_ok = (d01 > MIN_LANDMARK_DISTANCE) & (d02 > MIN_LANDMARK_DISTANCE) \
            & (d12 > MIN_LANDMARK_DISTANCE)
        crops = align_crop(imgs, kps, self.base_pts, CROP_SIZE)
        emb = self.embedder(crops)
        return emb, ok.to(self.device) & det_ok & kp_ok
