"""The retrieval pipelines (counterpart of the JAX
``configs/retrieval_common.py::build_pipelines`` and ``configs/pipelines.py``):
the head pipeline, photo -> ``Preproc3`` -> the species' head embedder -> a
512-d vector, and the body pipeline, photo -> ``Preproc4`` (Mask R-CNN box
crop, no mask) -> ``resize_with_padding`` to 256 x 256 -> the species' body
embedder -> a 512-d vector.

The models come in as arguments: a keypoint detector and two head embedders,
for dogs (animal type 1) and cats (type 2), and for the body a Mask R-CNN and
two body embedders. :func:`build_retrieval_models` makes them at full width
with seeded random weights (no trained torch weights exist);
``weights.retrieval_state_dicts`` carries the JAX package's over.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from .device import float32_matmuls, resolve_device
from .models.embedder import resnet50_embedder
from .models.rcnn import KEYPOINT_ARCHS, maskrcnn_resnet50_fpn
from .preprocessor import Preproc3, Preproc4
from .serving import build_serving_models, serving_detector
from .utils.preprocs import resize_with_padding
from .weights import init_random_

DOG, CAT = 1, 2
BODY_SIZE = (256, 256)


def _embedder(seed: int, dev: torch.device) -> nn.Module:
    return init_random_(resnet50_embedder(512), seed).eval().requires_grad_(False).to(dev)


def build_retrieval_models(device: str | torch.device = "cuda", seed: int = 0,
                           arch: str = "resnet50", body: bool = False,
                           ) -> tuple[nn.Module, ...]:
    """``(detector, dog_embedder, cat_embedder)``: the serving detector of
    ``serving.build_serving_models`` (``arch``: ``"resnet50"`` or
    ``"mobile"``, the JAX ``PFR_KEYPOINT_ARCH`` values) and two ResNet-50 ->
    512 embedders, with weights from ``seed``, ``seed + 1`` and ``seed + 2``,
    in eval mode. With ``body``, three more for the body pipeline:
    ``(mask_detector, dog_body_embedder, cat_body_embedder)``, the detector
    of :func:`mask_detector` (random weights from ``seed + 3`` when no
    checkpoint is found) and two embedders from ``seed + 4`` and ``seed + 5``."""
    dev = resolve_device(device)
    detector, dog, _ = build_serving_models(dev, seed, detector_kind=arch)
    models = (detector, dog, _embedder(seed + 2, dev))
    if body:
        models += (mask_detector(dev, seed + 3), _embedder(seed + 4, dev),
                   _embedder(seed + 5, dev))
    return models


def _checkpoint(env: str, default: str) -> Path | None:
    """The port checkpoint that ``env`` names (a folder gives its newest
    ``epoch=*-step=*``), else the one at ``default``, else ``None``; raises
    when ``env`` names no checkpoint."""
    from .engine.checkpoint import latest_checkpoint

    named = os.environ.get(env)
    ckpt = Path(named or default)
    if ckpt.is_dir():
        ckpt = latest_checkpoint(ckpt)
    if ckpt is None or not ckpt.is_file():
        if named:
            raise FileNotFoundError(f"{env}={named}: no port checkpoint there")
        return None
    return ckpt


def mask_detector(device: str | torch.device = "cuda", seed: int = 0) -> nn.Module:
    """The body detector, as the JAX ``configs/pipelines.py::mask_pipeline``
    resolves it: ``maskrcnn_resnet50_fpn(num_classes=2,
    box_detections_per_img=3)`` at ``RCNNConfig``'s test budgets (RPN 1000 a
    level into NMS, 1000 out; box NMS 0.5; score threshold 0.05), loading
    the port checkpoint named by ``PFR_MASK_CKPT`` (default
    ``results/mask/checkpoints``; a folder gives its newest
    ``epoch=*-step=*``). Without the variable and without a checkpoint at the
    default, seeded random weights from ``seed``; a ``PFR_MASK_CKPT`` that
    names no checkpoint raises. In eval mode on ``device``."""
    from .engine.checkpoint import load_params

    dev = resolve_device(device)
    detector = maskrcnn_resnet50_fpn(num_classes=2, box_detections_per_img=3)
    ckpt = _checkpoint("PFR_MASK_CKPT", "results/mask/checkpoints")
    if ckpt is None:
        print(f"no mask checkpoint at results/mask/checkpoints: seeded random weights "
              f"(seed {seed})", flush=True)
        init_random_(detector, seed)
    else:
        detector.load_state_dict(load_params(ckpt), strict=True)
    return detector.eval().requires_grad_(False).to(dev)


def keypoint_detector(device: str | torch.device = "cuda", seed: int = 0) -> nn.Module:
    """The head detector of the offline transforms, as the JAX
    ``configs/pipelines.py::keypoint_pipeline`` resolves it: the port
    checkpoint named by ``PFR_KEYPOINT_CKPT`` (default
    ``results/keypoint/checkpoints``; a folder gives its newest
    ``epoch=*-step=*``), loaded into the ``PFR_KEYPOINT_ARCH`` detector with
    frozen norms at ``RCNNConfig``'s test budgets (the RPN's top 1000 a
    level into NMS, 1000 an image out), as the JAX factory builds it. Without the
    variable and without a checkpoint at the default, the serving detector
    of :func:`build_retrieval_models` with weights from ``seed``
    (``serving.serving_detector``, at the serving budgets of 128 and 16); a
    ``PFR_KEYPOINT_CKPT`` that names no checkpoint raises. In eval mode on
    ``device``."""
    from .engine.checkpoint import load_params
    from .models.rcnn import keypointrcnn_resnet50_fpn, mobile_net_v3_large_keypoint_rcnn

    dev = resolve_device(device)
    arch = keypoint_arch()
    ckpt = _checkpoint("PFR_KEYPOINT_CKPT", "results/keypoint/checkpoints")
    if ckpt is None:
        print(f"no keypoint checkpoint at results/keypoint/checkpoints: "
              f"seeded random weights (seed {seed})", flush=True)
        return serving_detector(dev, seed, arch)
    detector = (keypointrcnn_resnet50_fpn(num_classes=2, num_keypoints=3) if arch == "resnet50"
                else mobile_net_v3_large_keypoint_rcnn(frozen_stats=True))
    detector.load_state_dict(load_params(ckpt), strict=True)
    return detector.eval().requires_grad_(False).to(dev)


def keypoint_arch() -> str:
    """``PFR_KEYPOINT_ARCH`` (default ``resnet50``), as the JAX
    ``configs/pipelines.py::keypoint_pipeline`` reads it; raises on a value
    other than ``resnet50`` or ``mobile``."""
    arch = os.environ.get("PFR_KEYPOINT_ARCH", "resnet50")
    if arch not in KEYPOINT_ARCHS:
        raise ValueError(f"PFR_KEYPOINT_ARCH={arch!r}: resnet50 | mobile")
    return arch


def build_head_pipeline(detector: nn.Module, dog_embedder: nn.Module, cat_embedder: nn.Module,
                        device: str | torch.device = "cuda",
                        ) -> Callable[[np.ndarray, int], np.ndarray | None]:
    """``head_pipeline(img, animal_type)``: detect the head, align it, embed it
    with the species' embedder, and return the ``(512,)`` float32 vector, or
    ``None`` when the image fails (``AssertionError``, ``ValueError`` or
    ``OSError``, as the reference's loop skips them).

    The detection threshold is ``PFR_RETRIEVAL_THR`` (default 0.9, the
    reference's; lower it for random or weak detectors).
    """
    dev = resolve_device(device)
    thr = float(os.environ.get("PFR_RETRIEVAL_THR", 0.9))
    preproc3 = Preproc3(detector, thr=thr, device=dev)
    scale = torch.full((), 255.0, device=dev)  # a true division, as in Preproc3

    @torch.inference_mode()
    @float32_matmuls()
    def head_pipeline(img: np.ndarray, animal_type: int) -> np.ndarray | None:
        try:
            aligned = preproc3(img)
        except (AssertionError, ValueError, OSError):
            return None
        fe = dog_embedder if animal_type == DOG else cat_embedder
        return fe(aligned[None] / scale)[0].cpu().numpy()

    return head_pipeline


def build_body_pipeline(detector: nn.Module, dog_embedder: nn.Module, cat_embedder: nn.Module,
                        device: str | torch.device = "cuda",
                        ) -> Callable[[np.ndarray, int], np.ndarray | None]:
    """``body_pipeline(img, animal_type)``: crop the Mask R-CNN's top body box
    (``Preproc4`` without the mask), truncate to uint8, letterbox to 256 x 256
    as PIL's ``thumbnail`` and centred pad do (``resize_with_padding``, on the
    host), divide by 255, embed with the species' body embedder, and return
    the ``(512,)`` float32 vector, or ``None`` when the image fails
    (``AssertionError``, ``ValueError`` or ``OSError``). The detection
    threshold is ``PFR_RETRIEVAL_THR`` (default 0.9), as for the head."""
    dev = resolve_device(device)
    thr = float(os.environ.get("PFR_RETRIEVAL_THR", 0.9))
    preproc4 = Preproc4(detector, thr=thr, device=dev)
    scale = torch.full((), 255.0, device=dev)

    @torch.inference_mode()
    @float32_matmuls()
    def body_pipeline(img: np.ndarray, animal_type: int) -> np.ndarray | None:
        try:
            crop = preproc4(img)
        except (AssertionError, ValueError, OSError):
            return None
        padded = resize_with_padding(crop.to(torch.uint8).cpu().numpy(), BODY_SIZE)
        fe = dog_embedder if animal_type == DOG else cat_embedder
        return fe(torch.from_numpy(padded).to(dev)[None].float() / scale)[0].cpu().numpy()

    return body_pipeline
