"""Detect -> align inference pipeline on original photos (counterpart of the JAX
``preprocessor/__init__.py``: ``_ModelPipeline`` and ``Preproc3``).

``Preproc3.batch(images)`` letterboxes each photo to the detector's input size
on the pipeline's device, runs the keypoint detector once over the batch (zero
padded to ``serve_batch`` when set), maps the top detection's landmarks back
to the photo with ``(kps - pad) / scale``, rounds them, and keeps an image when
its score exceeds ``thr`` and its landmarks are pairwise more than
``min_distance`` px apart. Each kept photo is then warped at its own shape to
the aligned crop by kernel K1 (one launch of batch 1 per photo), from the
4-point homography of the landmarks and their rounded centroid, solved on the
host. Where the JAX package warps the photos on the host with
``cv2.warpPerspective``, the port warps them on the device; cv2 snaps sample
positions to 1/32 px, K1 does not. ``__call__(img)`` keeps the reference's
single-image contract and raises ``AssertionError`` for an image that fails.
Everything runs in float32 with TF32 off.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..device import float32_matmuls, resolve_device
from ..ops.homography import alignment_homographies, warp_perspective_batch_cuda
from ..utils.collate import letterbox_image
from .align import align, align_batch

__all__ = ["DEFAULT_BASE_PTS", "Preproc3", "align", "align_batch"]

# Canonical head landmarks in the 224 x 224 crop.
DEFAULT_BASE_PTS = np.array([[70.0, 92.0], [154.0, 92.0], [112.0, 160.0]], np.float32)


def _rgb(img: np.ndarray | torch.Tensor, device: torch.device) -> torch.Tensor:
    """An ``(H, W)``, ``(H, W, 3)`` or ``(H, W, 4)`` image as ``(H, W, 3)`` on ``device``."""
    t = torch.as_tensor(img).to(device)
    if t.dim() == 2:
        t = torch.stack([t] * 3, -1)
    return t[..., :3]


class _ModelPipeline:
    """A detector (an ``nn.Module`` taking ``(B, H, W, 3)`` float images in
    [0, 1]) and the letterboxing in front of it."""

    def __init__(self, model: nn.Module, input_size: tuple[int, int] = (320, 320),
                 serve_batch: int | None = None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.input_size = tuple(input_size)
        # when set, every detector call is zero-padded to this many images
        self.serve_batch = serve_batch

    def _prepare(self, images: Sequence[torch.Tensor]):
        """Letterbox ``(H, W, 3)`` device images to the input size. Returns
        ``(batch (B, H, W, 3) float32 on the device, scales (B,), pads (B, 2))``,
        the last two float32 numpy arrays."""
        H, W = self.input_size
        batch = torch.zeros((len(images), H, W, 3), dtype=torch.float32, device=self.device)
        scales = np.zeros(len(images), np.float32)
        pads = np.zeros((len(images), 2), np.float32)
        for i, img in enumerate(images):
            canvas, scale, (px, py) = letterbox_image(img, (H, W))
            canvas = canvas.float()
            # divide only uint8-range canvases (the reference's test on the
            # max), by a tensor: CUDA divides by a Python scalar as a product
            # with its reciprocal, which can differ in the last bit
            if float(canvas.max()) > 1.5:
                canvas = canvas / torch.full((), 255.0, device=self.device)
            batch[i] = canvas
            scales[i] = scale
            pads[i] = (px, py)
        return batch, scales, pads

    def _detect(self, images: Sequence[torch.Tensor]):
        """``_prepare`` + the detector, zero-padded to ``serve_batch``. Returns
        ``(out, n, scales, pads)``, every output a numpy array of the ``n``
        real rows."""
        batch, scales, pads = self._prepare(images)
        n = len(batch)
        if self.serve_batch is not None and n != self.serve_batch:
            if n > self.serve_batch:
                raise ValueError(f"{n} images exceed serve_batch={self.serve_batch}")
            batch = torch.cat([batch, batch.new_zeros((self.serve_batch - n, *batch.shape[1:]))])
        dets = self.model(batch)
        out = {k: v[:n].cpu().numpy() for k, v in dets.items()}
        return out, n, scales, pads


class Preproc3(_ModelPipeline):
    """Head landmarks -> aligned crop (the production head pipeline)."""

    def __init__(self, model: nn.Module, thr: float = 0.9, min_distance: float = 5.0,
                 base_pts=DEFAULT_BASE_PTS, dsize=(224, 224, 3), input_size=(320, 320),
                 return_for_metrics: bool = False, serve_batch: int | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(model, input_size, serve_batch, device)
        self.thr = thr
        self.min_distance = min_distance
        self.base_pts = np.asarray(base_pts, np.float32)
        self.dsize = tuple(dsize)
        self.return_for_metrics = return_for_metrics

    @torch.inference_mode()
    @float32_matmuls()
    def batch(self, images) -> tuple[torch.Tensor, np.ndarray, dict]:
        """Photos (a list, or one ``(H, W, C)`` array) -> ``(aligned (B, h, w, 3)
        float32 in the photos' value range on the device, zero where invalid;
        valid (B,) bool; raw)``, ``raw`` holding the top scores, the rounded
        landmarks and the boxes in photo coordinates."""
        if isinstance(images, (np.ndarray, torch.Tensor)) and images.ndim == 3:
            images = [images]
        photos = [_rgb(img, self.device) for img in images]
        out, n, scales, pads = self._detect(photos)

        scores = out["scores"][:, 0]
        det_valid = out["valid"][:, 0]
        # landmarks back to photo coordinates, rounded to the pixel grid before
        # the distance rule and the alignment, as the reference does
        kps = out["keypoints"][:, 0, :, :2]
        kps = np.round((kps - pads[:, None, :]) / scales[:, None, None]).astype(np.float32)
        d01 = np.linalg.norm(kps[:, 0] - kps[:, 1], axis=-1)
        d02 = np.linalg.norm(kps[:, 0] - kps[:, 2], axis=-1)
        d12 = np.linalg.norm(kps[:, 1] - kps[:, 2], axis=-1)
        valid = (det_valid & (scores > self.thr) & (d01 > self.min_distance)
                 & (d02 > self.min_distance) & (d12 > self.min_distance))

        out_hw = self.dsize[:2]
        aligned = torch.zeros((n, *out_hw, 3), dtype=torch.float32, device=self.device)
        # maps from the rounded landmarks and both rounded centroids, solved on
        # the host whatever the device (the same float32 map on the card and
        # on the CPU: a photo thousands of pixels wide magnifies the two
        # solvers' last-bit differences to whole levels in the crop); K1 warps
        # each kept photo at its own shape (a batch of one)
        Hs = alignment_homographies(torch.from_numpy(kps),
                                    torch.from_numpy(self.base_pts)).to(self.device)
        for i in np.nonzero(valid)[0]:
            photo = photos[i].float().contiguous()[None]
            aligned[i] = warp_perspective_batch_cuda(photo, Hs[i:i + 1].contiguous(), out_hw)[0]
        raw = {"scores": scores, "keypoints": kps,
               "boxes": (out["boxes"][:, 0] - np.tile(pads, 2)) / scales[:, None]}
        return aligned, np.asarray(valid), raw

    def __call__(self, img):
        aligned, valid, raw = self.batch([img])
        if not valid[0]:
            raise AssertionError("Preproc3: low score or degenerate landmarks")
        if self.return_for_metrics:
            return raw["keypoints"][0].astype(int)
        return aligned[0]
