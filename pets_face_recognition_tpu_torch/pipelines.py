"""The head retrieval pipeline: photo -> ``Preproc3`` -> the species' embedder
-> a 512-d vector (counterpart of the head half of the JAX
``configs/retrieval_common.py::build_pipelines``).

The models come in as arguments: one keypoint detector and two embedders, for
dogs (animal type 1) and cats (type 2). :func:`build_retrieval_models` makes
them at full width with seeded random weights (no trained torch weights
exist); ``weights.retrieval_state_dicts`` carries the JAX package's over.
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
from .models.rcnn import KEYPOINT_ARCHS
from .preprocessor import Preproc3
from .serving import build_serving_models, serving_detector
from .weights import init_random_

DOG, CAT = 1, 2


def build_retrieval_models(device: str | torch.device = "cuda", seed: int = 0,
                           arch: str = "resnet50",
                           ) -> tuple[nn.Module, nn.Module, nn.Module]:
    """``(detector, dog_embedder, cat_embedder)``: the serving detector of
    ``serving.build_serving_models`` (``arch``: ``"resnet50"`` or
    ``"mobile"``, the JAX ``PFR_KEYPOINT_ARCH`` values) and two ResNet-50 ->
    512 embedders, with weights from ``seed``, ``seed + 1`` and ``seed + 2``,
    in eval mode."""
    dev = resolve_device(device)
    detector, dog, _ = build_serving_models(dev, seed, detector_kind=arch)
    cat = init_random_(resnet50_embedder(512), seed + 2).eval().requires_grad_(False).to(dev)
    return detector, dog, cat


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
    from .engine.checkpoint import latest_checkpoint, load_params
    from .models.rcnn import keypointrcnn_resnet50_fpn, mobile_net_v3_large_keypoint_rcnn

    dev = resolve_device(device)
    arch = keypoint_arch()
    named = os.environ.get("PFR_KEYPOINT_CKPT")
    ckpt = Path(named or "results/keypoint/checkpoints")
    if ckpt.is_dir():
        ckpt = latest_checkpoint(ckpt)
    if ckpt is None or not ckpt.is_file():
        if named:
            raise FileNotFoundError(f"PFR_KEYPOINT_CKPT={named}: no port checkpoint there")
        print(f"no keypoint checkpoint at {ckpt or 'results/keypoint/checkpoints'}: "
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
