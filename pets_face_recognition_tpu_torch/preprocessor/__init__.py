"""Detect -> align or crop inference pipelines on original photos (counterpart
of the JAX ``preprocessor/__init__.py``: ``_ModelPipeline``, ``Preproc3``,
``Preproc4``, ``Preproc5``, ``Preproc6`` and ``PreprocCombined``).

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

``Preproc4`` crops the body box of the Mask R-CNN's top detection (rounded
to the pixel grid) from the photo on its device; with ``use_mask`` it pastes
the detection's 28 x 28 mask at the photo's full resolution
(``ops.masks.paste_mask``), keeps the pixels strictly above ``mask_thr``,
multiplies the photo by them and tightens the box to the mask's extents (the
extents alone cross to the host); an empty mask or crop drops the image.
``Preproc6`` is the same crop from the keypoint detector's head box,
``Preproc5`` weighs the photo by a soft mask (squared below ``mask_thr``)
without tightening, and ``PreprocCombined`` aligns the head of the masked
body crop. Everything runs in float32 with TF32 off.

The dataset-version pipelines ``Preproc7``-``13`` are ``Preproc3`` (aligned)
or ``Preproc6`` (head box crop) bound to a keypoint checkpoint variant
(``pipelines.KEYPOINT_VARIANTS``): built without a model, they load
``pipelines.keypoint_detector(variant=...)`` on first use, as the JAX
package's deferred loader does; an explicit model wins. ``IdentityPreproc``
passes photos through.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..device import float32_matmuls, resolve_device
from ..ops.homography import alignment_homographies, warp_perspective_batch_cuda
from ..ops.masks import paste_mask
from ..utils.collate import letterbox_image
from .align import align, align_batch

__all__ = ["DEFAULT_BASE_PTS", "IdentityPreproc", "Preproc3", "Preproc4", "Preproc5",
           "Preproc6", "Preproc7", "Preproc8", "Preproc9", "Preproc10", "Preproc11",
           "Preproc12", "Preproc13", "PreprocCombined", "align", "align_batch"]

# Canonical head landmarks in the 224 x 224 crop.
DEFAULT_BASE_PTS = np.array([[70.0, 92.0], [154.0, 92.0], [112.0, 160.0]], np.float32)


def _rgb(img: np.ndarray | torch.Tensor, device: torch.device) -> torch.Tensor:
    """An ``(H, W)``, ``(H, W, 3)`` or ``(H, W, 4)`` image as ``(H, W, 3)`` on ``device``."""
    t = torch.as_tensor(img).to(device)
    if t.dim() == 2:
        t = torch.stack([t] * 3, -1)
    return t[..., :3]


def _photos(images, device: torch.device) -> list[torch.Tensor]:
    """A list of photos, or one ``(H, W, C)`` photo, as ``(H, W, 3)`` tensors on
    ``device``."""
    if isinstance(images, (np.ndarray, torch.Tensor)) and images.ndim == 3:
        images = [images]
    return [_rgb(img, device) for img in images]


class _ModelPipeline:
    """A detector (an ``nn.Module`` taking ``(B, H, W, 3)`` float images in
    [0, 1]) and the letterboxing in front of it. ``model`` may be ``None``
    when ``_loader(device)`` is set: the detector is then loaded on first use."""

    _loader = None

    def __init__(self, model: nn.Module | None, input_size: tuple[int, int] = (320, 320),
                 serve_batch: int | None = None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.input_size = tuple(input_size)
        # when set, every detector call is zero-padded to this many images
        self.serve_batch = serve_batch

    @property
    def model(self) -> nn.Module:
        if self._model is None:
            if self._loader is None:
                raise ValueError(f"{type(self).__name__}: no model and no loader")
            self._model = self._loader(self.device)
        return self._model

    @model.setter
    def model(self, model: nn.Module | None) -> None:
        self._model = model

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
        photos = _photos(images, self.device)
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


class Preproc4(_ModelPipeline):
    """Body box crop through Mask R-CNN (the production body pipeline), with
    the mask multiplied in and the box tightened to it when ``use_mask`` (or
    the reference's keyword ``masked``)."""

    def __init__(self, model: nn.Module, thr: float = 0.9, use_mask: bool = False,
                 mask_thr: float = 0.5, out_size: tuple[int, int] | None = None,
                 input_size=(320, 320), return_for_metrics: bool = False,
                 serve_batch: int | None = None, masked: bool | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(model, input_size, serve_batch, device)
        self.thr = thr
        self.use_mask = use_mask if masked is None else masked
        self.mask_thr = mask_thr
        self.out_size = out_size
        self.return_for_metrics = return_for_metrics

    def _mask_extents(self, mask: np.ndarray, box: np.ndarray, img: torch.Tensor):
        """Paste ``mask`` into ``img``'s frame, keep ``> mask_thr``; returns
        ``(img * binary, (col0, row0, col1, row1) extents)``, or ``None`` for
        an all-zero mask."""
        h, w = img.shape[:2]
        binary = paste_mask(mask, box.astype(np.float64), h, w, device=self.device) \
            > self.mask_thr
        cols = torch.nonzero(binary.any(0)).flatten()
        rows = torch.nonzero(binary.any(1)).flatten()
        ext = torch.stack([cols[:1], rows[:1], cols[-1:], rows[-1:]]).flatten() \
            if cols.numel() else cols
        ext = ext.cpu().tolist()
        if not ext:
            return None
        return img * binary[:, :, None], ext

    @torch.inference_mode()
    @float32_matmuls()
    def batch(self, images):
        """Photos -> ``(crops, valid (B,) bool, raw)``: ``crops`` a list of
        float32 ``(h, w, 3)`` tensors on the device (``None`` where invalid),
        or with ``out_size`` one ``(B, H, W, 3)`` tensor of letterboxed crops;
        ``raw`` the top scores, the boxes in photo coordinates (tightened
        where the mask tightened them) and every detection's score (0 where
        invalid)."""
        photos = _photos(images, self.device)
        out, _, scales, pads = self._detect(photos)
        all_scores = out["scores"]
        scores = all_scores[:, 0]
        valid = out["valid"][:, 0] & (scores > self.thr)
        boxes = (out["boxes"][:, 0] - np.tile(pads, 2)) / scales[:, None]
        crops = []
        for i, photo in enumerate(photos):
            img = photo.float()
            if not valid[i]:
                crops.append(None)
                continue
            h, w = img.shape[:2]
            bb = np.round(boxes[i]).astype(int)          # rounded before tightening
            if self.use_mask and "masks" in out:
                cut = self._mask_extents(out["masks"][i, 0], boxes[i], img)
                if cut is None:
                    valid[i] = False
                    crops.append(None)
                    continue
                img, (c0, r0, c1, r1) = cut
                bb = np.array([max(bb[0], c0), max(bb[1], r0), min(bb[2], c1 + 1),
                               min(bb[3], r1 + 1)])
                boxes[i] = bb
            x1, y1 = max(int(bb[0]), 0), max(int(bb[1]), 0)
            x2, y2 = min(int(bb[2]), w), min(int(bb[3]), h)
            if x2 <= x1 or y2 <= y1:
                valid[i] = False
                crops.append(None)
                continue
            crops.append(img[y1:y2, x1:x2])
        if self.out_size is not None:
            fixed = torch.zeros((len(photos), *self.out_size, 3), dtype=torch.float32,
                                device=self.device)
            for i, c in enumerate(crops):
                if c is not None:
                    fixed[i] = letterbox_image(c, self.out_size)[0]
            crops = fixed
        raw = {"scores": scores, "boxes": boxes,
               "all_scores": np.where(out["valid"], all_scores, 0.0)}
        return crops, np.asarray(valid), raw

    def __call__(self, img):
        crops, valid, raw = self.batch([img])
        if not valid[0]:
            raise AssertionError(f"{type(self).__name__}: low detection score")
        if self.return_for_metrics:
            return np.round(raw["boxes"][0]).astype(int), raw["all_scores"][0]
        return crops[0]


class Preproc6(Preproc4):
    """Head box crop without alignment, from the keypoint detector's box."""

    def __init__(self, model: nn.Module, thr: float = 0.9, out_size=None,
                 input_size=(320, 320), return_for_metrics: bool = False,
                 serve_batch: int | None = None, device: str | torch.device = "cuda"):
        super().__init__(model, thr=thr, use_mask=False, out_size=out_size,
                         input_size=input_size, return_for_metrics=return_for_metrics,
                         serve_batch=serve_batch, device=device)


class Preproc5(_ModelPipeline):
    """Soft-mask body crop: mask probabilities below ``mask_thr`` squared,
    those above it 1; the weighted photo cropped to the rounded top box, not
    tightened."""

    def __init__(self, model: nn.Module, thr: float = 0.9, mask_thr: float = 0.5,
                 input_size=(320, 320), serve_batch: int | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(model, input_size, serve_batch, device)
        self.thr = thr
        self.mask_thr = mask_thr

    @torch.inference_mode()
    @float32_matmuls()
    def batch(self, images):
        photos = _photos(images, self.device)
        out, _, scales, pads = self._detect(photos)
        scores = out["scores"][:, 0]
        valid = out["valid"][:, 0] & (scores > self.thr)
        boxes = (out["boxes"][:, 0] - np.tile(pads, 2)) / scales[:, None]
        crops = []
        for i, photo in enumerate(photos):
            img = photo.float()
            if not valid[i]:
                crops.append(None)
                continue
            h, w = img.shape[:2]
            x1, y1, x2, y2 = np.round(boxes[i]).astype(int)
            x1, y1, x2, y2 = max(x1, 0), max(y1, 0), min(x2, w), min(y2, h)
            if x2 <= x1 or y2 <= y1:
                valid[i] = False
                crops.append(None)
                continue
            full = paste_mask(out["masks"][i, 0], boxes[i].astype(np.float64), h, w,
                              device=self.device)
            soft = torch.where(full < self.mask_thr, full ** 2, torch.ones_like(full))
            crops.append((img * soft[..., None])[y1:y2, x1:x2])
        return crops, np.asarray(valid), {"scores": scores, "boxes": boxes}

    def __call__(self, img):
        crops, valid, _ = self.batch([img])
        if not valid[0]:
            raise AssertionError("Preproc5: low detection score")
        return crops[0].clamp(0, 255).to(torch.uint8)


class PreprocCombined:
    """Mask, then landmarks: the head aligned from the masked body crop."""

    def __init__(self, keypoint_pipeline: Preproc3, mask_pipeline: Preproc4):
        self.keypoint_pipeline = keypoint_pipeline
        self.mask_pipeline = mask_pipeline

    def __call__(self, img):
        return self.keypoint_pipeline(self.mask_pipeline(img))

    def batch(self, images):
        """Each photo's body crop (the photo itself where that fails) through
        the keypoint pipeline; valid where both pipelines kept it."""
        photos = _photos(images, self.mask_pipeline.device)
        crops, valid, _ = self.mask_pipeline.batch(photos)
        usable = [c if v and c is not None else p for c, v, p in zip(crops, valid, photos)]
        aligned, valid2, raw = self.keypoint_pipeline.batch(usable)
        return aligned, np.asarray(valid) & np.asarray(valid2), raw


def _variant_loader(variant: str):
    """Deferred loader of ``variant``'s keypoint detector (``load(device)``)."""
    def load(device):
        from ..pipelines import keypoint_detector

        return keypoint_detector(device, variant=variant)

    load.variant = variant
    return load


class _VariantBinding:
    """Mixin: built without a model, bind the class's checkpoint variant."""

    CKPT_VARIANT = "prod"

    def __init__(self, model: nn.Module | None = None, *args, **kwargs):
        super().__init__(model, *args, **kwargs)
        if model is None:
            self._loader = _variant_loader(self.CKPT_VARIANT)


class Preproc7(_VariantBinding, Preproc3):
    """Aligned head crop, dataset-v2 keypoint checkpoint."""

    CKPT_VARIANT = "v2"


class Preproc8(_VariantBinding, Preproc6):
    """Head box crop, dataset-v2 keypoint checkpoint."""

    CKPT_VARIANT = "v2"


class Preproc9(_VariantBinding, Preproc3):
    """Aligned head crop, dataset-v3 keypoint checkpoint."""

    CKPT_VARIANT = "v3"


class Preproc10(_VariantBinding, Preproc6):
    """Head box crop, dataset-v3 keypoint checkpoint."""

    CKPT_VARIANT = "v3"


class Preproc11(_VariantBinding, Preproc3):
    """Aligned head crop, dataset-v4 keypoint checkpoint."""

    CKPT_VARIANT = "v4"


class Preproc12(_VariantBinding, Preproc6):
    """Head box crop, dataset-v4 keypoint checkpoint."""

    CKPT_VARIANT = "v4"


class Preproc13(_VariantBinding, Preproc6):
    """Head box crop on the production keypoint checkpoint (as ``Preproc6``)."""

    CKPT_VARIANT = "prod"


class IdentityPreproc:
    """Passthrough."""

    def __call__(self, img):
        return img

    def batch(self, images):
        arr = [np.asarray(i) for i in images]
        return arr, np.ones(len(arr), bool), {}
