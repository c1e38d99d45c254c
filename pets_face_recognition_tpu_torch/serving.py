"""Serving: batched detect -> align -> embed over decoded images or JPEG files
(counterpart of the JAX ``serving.py`` and of ``bench.py::build_serving_models``).

``embed_batch`` takes uint8 NHWC images and a decode-ok mask and returns
``(B, 512)`` embeddings and a ``(B,)`` validity mask. Validity follows the
reference's assert-and-skip: the top detection must score above
``score_thr`` and its landmarks, rounded to the pixel grid, must be pairwise
more than 5 px apart. The models compute in their own ``dtype`` (float32 by
default, bfloat16 as the JAX serving models on an accelerator); products
run with TF32 off and bfloat16 sums in float32 inside ``embed_batch``,
whatever the caller set. On a CUDA device the path goes through kernels K2
and K3 (in the detector) and K1 (in ``align_crop``). K1 runs in the
service's ``warp_dtype``: bfloat16 by default, as JAX's ``EmbeddingService``
(``torch.float32`` for the exact warp, ``torch.int8`` for its int8 mode);
on the CPU the warp is the exact float32 one whatever ``warp_dtype`` says,
as JAX's ``align_crop`` on its CPU backend.

``stream`` runs ``embed_batch`` over image files: one producer thread decodes
and letterboxes the next batches (``native.decode_batch``, PIL where no
native route is installed) into a queue of ``prefetch`` batches while the
device embeds the current one; the tail batch is padded with its last path.

With a ``mesh`` (``parallel.create_mesh``) the batch is split over its ``data``
axis: each process embeds its contiguous rows and the rows of every rank are
gathered in order, so every process returns the whole batch. Every stage is
per image, so nothing else crosses the processes; ``batch_size`` must divide
by the axis (``ValueError``, as in JAX).
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch
from torch import nn

from . import parallel
from .device import float32_matmuls, resolve_device
from .models.embedder import resnet50_embedder
from .models.rcnn import (KEYPOINT_ARCHS, keypointrcnn_resnet50_fpn,
                          mobile_net_v3_large_keypoint_rcnn)
from .ops.homography import WARP_DTYPES, align_crop
from .utils.collate import letterbox_image
from .weights import init_random_

DEFAULT_BASE_PTS = ((70.0, 92.0), (154.0, 92.0), (112.0, 160.0))
CROP_SIZE = (224, 224)
MIN_LANDMARK_DISTANCE = 5.0
# serving RPN budgets: one pet head per image, so 128 pre-NMS / 16 post-NMS
# proposals per image lose nothing (the JAX serving default, bench.py)
RPN_PRE_NMS_TOP_N, RPN_POST_NMS_TOP_N = 128, 16


def build_serving_models(device: str | torch.device = "cuda", seed: int = 0,
                         detector_kind: str = "resnet50", dtype: torch.dtype = torch.float32,
                         ) -> tuple[nn.Module, nn.Module, torch.Tensor]:
    """The serving detector (3 keypoints, 1 detection per image, RPN budgets
    128/16, frozen norms) of ``detector_kind``: ``"resnet50"``, the
    ResNet-50-FPN keypoint R-CNN, or ``"mobile"``, the MobileNetV3-Large one
    (JAX ``bench.py --detector mobile``: a 2-level FPN over ``c4``/``c5``, 15
    anchors a location); and the ResNet-50 512-d embedder, with seeded random
    weights, in eval mode on ``device``. Returns ``(detector, embedder,
    base_pts (3, 2))``. The default stays ``"resnet50"``, the port's first
    serving detector, so that callers written for it keep their meaning; the
    JAX ``bench.py`` defaults to ``"mobile"``. ``dtype`` is both models'
    compute dtype (the JAX ``bench.py`` ``bf16`` switch; the weights are the
    same whatever it is); it stays float32 by default, the module default."""
    dev = resolve_device(device)
    detector = serving_detector(dev, seed, detector_kind, dtype=dtype)
    embedder = init_random_(resnet50_embedder(512, dtype=dtype), seed + 1)
    embedder = embedder.eval().requires_grad_(False).to(dev)
    return detector, embedder, torch.tensor(DEFAULT_BASE_PTS, device=dev)


def serving_detector(device: str | torch.device = "cuda", seed: int = 0,
                     detector_kind: str = "resnet50", quant: str | None = None,
                     quant_kp: str | None = None, dtype: torch.dtype = torch.float32
                     ) -> nn.Module:
    """:func:`build_serving_models`' detector alone, the same weights from
    ``seed``; ``quant`` (the ResNet-50 trunk and RPN, scope ``rpn``) and
    ``quant_kp`` (the keypoint head) build its int8 twin over those weights
    (the MobileNetV3 trunk has no int8 path: ``quant`` is refused there);
    ``dtype`` is its compute dtype (float32 only with an int8 twin)."""
    dev = resolve_device(device)
    budgets = dict(rpn_pre_nms_top_n_test=RPN_PRE_NMS_TOP_N,
                   rpn_post_nms_top_n_test=RPN_POST_NMS_TOP_N)
    if detector_kind == "resnet50":
        detector = keypointrcnn_resnet50_fpn(num_classes=2, num_keypoints=3, quant=quant,
                                             quant_kp=quant_kp, dtype=dtype, **budgets)
    elif detector_kind == "mobile":
        if quant is not None:
            raise ValueError("the MobileNetV3 trunk has no int8 path: pass quant_kp alone")
        detector = mobile_net_v3_large_keypoint_rcnn(frozen_stats=True, quant_kp=quant_kp,
                                                     dtype=dtype, **budgets)
    else:
        raise ValueError(f"detector kind {detector_kind!r}: expected one of {KEYPOINT_ARCHS}")
    init_random_(detector, seed)
    return detector.eval().requires_grad_(False).to(dev)


def _decode_batch_host(paths: Sequence[Path], input_size: tuple[int, int]):
    """Decode and letterbox image files: ``(images (N, H, W, 3) uint8, ok (N,),
    scales (N,), pads (N, 2))``. The native route where one is installed and
    every file is a JPEG, else PIL with :func:`utils.collate.letterbox_image`;
    a file that does not decode comes back with ``ok`` False."""
    from . import native

    if native.is_available() and all(str(p).lower().endswith((".jpg", ".jpeg"))
                                     for p in paths):
        return native.decode_batch(list(paths), input_size)

    from PIL import Image

    H, W = input_size
    images = np.zeros((len(paths), H, W, 3), np.uint8)
    ok = np.zeros(len(paths), bool)
    scales = np.zeros(len(paths), np.float32)
    pads = np.zeros((len(paths), 2), np.float32)
    for i, p in enumerate(paths):
        try:
            with Image.open(p) as im:
                img = torch.from_numpy(np.array(im.convert("RGB")))
        except OSError:
            continue
        canvas, s, (px, py) = letterbox_image(img, (H, W))
        images[i] = canvas.numpy()
        ok[i] = True
        scales[i] = s
        pads[i] = (px, py)
    return images, ok, scales, pads


class EmbeddingService:
    """Head-embedding service over decoded uint8 image batches or image files.

    ``warp_dtype`` is K1's compute mode on a CUDA device (one of
    ``ops.homography.WARP_DTYPES``), bfloat16 by default as in JAX; the CPU
    warps in exact float32 whatever it is."""

    def __init__(self, detector: nn.Module, embedder: nn.Module,
                 base_pts: torch.Tensor | None = None, score_thr: float = 0.9,
                 device: str | torch.device = "cuda", batch_size: int = 64,
                 input_size: tuple[int, int] = (320, 320), prefetch: int = 2,
                 mesh: parallel.Mesh | None = None,
                 warp_dtype: torch.dtype = torch.bfloat16):
        if warp_dtype not in WARP_DTYPES:
            raise ValueError(f"warp_dtype {warp_dtype}: expected one of {WARP_DTYPES}")
        self.warp_dtype = warp_dtype
        self.device = resolve_device(device)
        if mesh is not None and batch_size % mesh.size:
            raise ValueError(f"batch_size {batch_size} not divisible by data axis {mesh.size}")
        self.mesh = mesh
        self.detector = detector
        self.embedder = embedder
        self.base_pts = torch.tensor(DEFAULT_BASE_PTS) if base_pts is None else base_pts
        self.base_pts = self.base_pts.to(self.device, torch.float32)
        self.score_thr = score_thr
        self.batch_size = batch_size
        self.input_size = tuple(input_size)
        self.prefetch = prefetch

    @torch.inference_mode()
    @float32_matmuls()
    def embed_batch(self, images_u8: torch.Tensor, ok: torch.Tensor):
        """``images_u8 (B, H, W, 3)`` uint8, ``ok (B,)`` bool ->
        ``(embeddings (B, 512) float32, valid (B,) bool)``; under a mesh this
        process embeds its rows and gathers every rank's."""
        if self.mesh is not None:
            rows = self.mesh.rows(images_u8.shape[0])
            emb, valid = self._embed(images_u8[rows], ok[rows])
            return (parallel.all_gather_rows(emb, self.mesh),
                    parallel.all_gather_rows(valid, self.mesh))
        return self._embed(images_u8, ok)

    def _embed(self, images_u8: torch.Tensor, ok: torch.Tensor):
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
        crops = align_crop(imgs, kps, self.base_pts, CROP_SIZE, compute_dtype=self.warp_dtype)
        emb = self.embedder(crops)
        return emb, ok.to(self.device) & det_ok & kp_ok

    def stream(self, paths: Iterable[str | Path]
               ) -> Iterator[tuple[list[Path], np.ndarray, np.ndarray]]:
        """Yield ``(batch_paths, embeddings (n, 512), valid (n,))`` per batch of
        ``batch_size`` files, decoding ahead on one producer thread. Files
        that do not decode come back invalid."""
        paths = [Path(p) for p in paths]
        batches = [paths[i:i + self.batch_size] for i in range(0, len(paths), self.batch_size)]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def produce():
            try:
                for chunk in batches:
                    padded = chunk + [chunk[-1]] * (self.batch_size - len(chunk))
                    images, ok, _, _ = _decode_batch_host(padded, self.input_size)
                    q.put((chunk, images, ok))
                    if stop.is_set():
                        return
                q.put(done)
            except Exception as e:  # handed to the consumer, which raises it
                q.put(e)

        producer = threading.Thread(target=produce, name="decode", daemon=True)
        producer.start()
        try:
            while (item := q.get()) is not done:
                if isinstance(item, Exception):
                    raise item
                chunk, images, ok = item
                emb, valid = self.embed_batch(torch.from_numpy(images), torch.from_numpy(ok))
                n = len(chunk)
                yield chunk, emb[:n].cpu().numpy(), valid[:n].cpu().numpy()
        finally:
            stop.set()
            while producer.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            producer.join()

    def embed_paths(self, paths: Sequence[str | Path]) -> tuple[np.ndarray, np.ndarray]:
        """Embed every file: ``(embeddings (N, 512), valid (N,))``."""
        embs, valids = [], []
        for _, e, v in self.stream(paths):
            embs.append(e)
            valids.append(v)
        if not embs:
            return np.zeros((0, 512), np.float32), np.zeros(0, bool)
        return np.concatenate(embs), np.concatenate(valids)
