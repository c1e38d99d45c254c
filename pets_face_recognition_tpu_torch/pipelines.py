"""The retrieval pipelines (counterpart of the JAX
``configs/retrieval_common.py::build_pipelines`` and ``configs/pipelines.py``):
the head pipeline, photo -> ``Preproc3`` -> the species' head embedder -> a
512-d vector, and the body pipeline, photo -> ``Preproc4`` (Mask R-CNN box
crop, no mask) -> ``resize_with_padding`` to 256 x 256 -> the species' body
embedder -> a 512-d vector.

The models come in as arguments: a keypoint detector and two head embedders,
for dogs (animal type 1) and cats (type 2), and for the body a Mask R-CNN and
two body embedders. :func:`build_retrieval_models` makes them at full width
from the port checkpoints that the JAX variables name (the head detector's
``PFR_KEYPOINT_CKPT``, ``PFR_MASK_CKPT``, the embedders'
``PFR_{DOG,CAT}_{HEAD,BODY}_FE_CKPT`` of ``configs/retrieval_config.py``),
or with seeded random weights where no checkpoint is found;
``weights.retrieval_state_dicts`` carries the JAX package's over.

Every factory obeys the process quant mode (``models/ptq.py``:
``PFR_QUANT_MODE``, ``PFR_QUANT_STATE``, ``PFR_QUANT_COMPONENTS``), as the
JAX ``configs/pipelines.py::_detector_fn`` and
``configs/retrieval_common.py::_embedder_fn`` do: under ``calibrate`` or
``int8`` the model is built as its quant twin over the same weights and
wrapped in a ``PTQModelFn``. Mask R-CNN supports only the ``detector``
component and the MobileNetV3 detector only ``kp_head``; a requested
component that a factory does not support falls back to float with JAX's
message. :func:`keypoint_detector` binds the dataset-version checkpoints of
``KEYPOINT_VARIANTS`` (``Preproc7``-``13``).

Every factory takes the model's compute ``dtype`` (float32 by default), the
int8 twins' included: in bfloat16 they calibrate in bfloat16 and serve their
exact int32 sums dequantized in float32 and cast to bfloat16 once, as JAX's
bench serves the int8 keypoint head on its bfloat16 detector. ``PFR_INPUT_DTYPE=bfloat16`` rounds
each embedder's input crop to bfloat16, as the JAX ``retrieval_common.py``
does, and the detector's batch in ``Preproc3``/``Preproc4``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from .device import float32_matmuls, resolve_device
from .models import ptq
from .models.embedder import resnet50_embedder
from .models.quant import load_float_state_dict, quant_state
from .models.rcnn import KEYPOINT_ARCHS, maskrcnn_resnet50_fpn
from .preprocessor import Preproc3, Preproc4, round_input
from .serving import serving_detector
from .utils.preprocs import resize_with_padding
from .weights import init_random_

DOG, CAT = 1, 2
BODY_SIZE = (256, 256)
# the embedders' checkpoint variables and defaults (JAX ``retrieval_config.py``)
FE_CKPTS = {"fe_cat_head": ("PFR_CAT_HEAD_FE_CKPT", "results/cat_fe/checkpoints"),
            "fe_dog_head": ("PFR_DOG_HEAD_FE_CKPT", "results/dog_fe/checkpoints"),
            "fe_cat_body": ("PFR_CAT_BODY_FE_CKPT", "results/cat_body_fe/checkpoints"),
            "fe_dog_body": ("PFR_DOG_BODY_FE_CKPT", "results/dog_body_fe/checkpoints")}
# dataset-version keypoint checkpoints (JAX ``configs/pipelines.py``): prod
# for Preproc3/6/13, v2 for Preproc7/8, v3 for Preproc9/10, v4 for Preproc11/12
KEYPOINT_VARIANTS = {
    "prod": ("PFR_KEYPOINT_CKPT", "results/keypoint/checkpoints"),
    "v2": ("PFR_KEYPOINT_CKPT_V2", "results/keypoint_v2/checkpoints"),
    "v3": ("PFR_KEYPOINT_CKPT_V3", "results/keypoint_v3/checkpoints"),
    "v4": ("PFR_KEYPOINT_CKPT_V4", "results/keypoint_v4/checkpoints"),
}


def detector_quant(name: str, supports: tuple[str, ...] = ("detector", "kp_head")
                   ) -> tuple[str, str | None, str | None]:
    """``(mode, quant, quant_kp)`` for a detector factory under the process
    quant mode, as the JAX ``_detector_fn`` decides them: ``supports`` lists
    the components the factory's model has; a requested one it lacks falls
    back to float, and is named."""
    mode = ptq.quant_mode()
    comps = ptq.quant_components() & set(supports)
    if mode:
        dropped = (ptq.quant_components() & {"detector", "kp_head"}) - comps
        if dropped:
            print(f"PTQ: {name}: requested quant component(s) "
                  f"{sorted(dropped)} unsupported by this factory — "
                  f"falling back to float for those stages")
    det_q = mode if (mode and "detector" in comps) else None
    kp_q = mode if (mode and "kp_head" in comps) else None
    if mode and det_q is None and kp_q is None:
        print(f"PTQ: {name}: no supported quant components selected "
              f"under PFR_QUANT_MODE={mode!r} — serving FLOAT")
    return mode, det_q, kp_q


def _served(name: str, model: nn.Module, mode: str, dev: torch.device) -> nn.Module:
    """``model`` in eval mode on ``dev``; a quant twin behind a
    ``PTQModelFn`` for the process quant ``mode``."""
    model = model.eval().requires_grad_(False).to(dev)
    if mode and quant_state(model):
        return ptq.PTQModelFn(ptq.PTQServing(name, model), mode)
    return model


def embedder(name: str, seed: int, device: str | torch.device = "cuda",
             dtype: torch.dtype = torch.float32) -> nn.Module:
    """One retrieval embedder (``name`` in :data:`FE_CKPTS`, e.g.
    ``fe_dog_head``): the port FE checkpoint that its variable names (a
    folder gives its newest ``epoch=*-step=*``; the margin head is dropped),
    else seeded random weights from ``seed``; a variable that names no
    checkpoint raises. Under ``PFR_QUANT_MODE`` with the ``embedder``
    component, its int8 twin (the trunk quantized, ``fc`` float), calibrated
    on what it embeds (224 x 224 head crops, 256 x 256 body crops). Eval mode
    on ``device``; the trunk computes in ``dtype``."""
    from .engine.checkpoint import load_params

    dev = resolve_device(device)
    mode = ptq.quant_mode()
    quant = mode if (mode and "embedder" in ptq.quant_components()) else None
    model = resnet50_embedder(512, quant=quant, dtype=dtype)
    ckpt = _checkpoint(*FE_CKPTS[name])
    if ckpt is None:
        init_random_(model, seed)
    else:
        sd = load_params(ckpt)
        if any(k.startswith("model.") for k in sd):
            sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
        load_float_state_dict(model, sd)
    return _served(name, model, mode, dev)


def build_retrieval_models(device: str | torch.device = "cuda", seed: int = 0,
                           arch: str = "resnet50", body: bool = False,
                           ) -> tuple[nn.Module, ...]:
    """``(detector, dog_embedder, cat_embedder)``, in eval mode, as the JAX
    ``configs/retrieval_common.py::build_pipelines`` resolves them: the head
    detector of :func:`keypoint_detector` (variant ``prod``: the port
    checkpoint that ``PFR_KEYPOINT_CKPT`` names, default
    ``results/keypoint/checkpoints``, in the ``arch`` model, ``"resnet50"`` or
    ``"mobile"``, at ``RCNNConfig``'s test budgets with one detection; without
    a checkpoint, the serving detector with weights from ``seed``) and the
    two head embedders of :func:`embedder` (their FE checkpoints, else
    weights from ``seed + 1`` and ``seed + 2``). With ``body``, three more for
    the body pipeline: ``(mask_detector, dog_body_embedder,
    cat_body_embedder)``, the detector of :func:`mask_detector` (random
    weights from ``seed + 3`` when no checkpoint is found) and two embedders
    (from ``seed + 4`` and ``seed + 5`` without checkpoints)."""
    dev = resolve_device(device)
    models = (keypoint_detector(dev, seed, "prod", arch=arch),
              embedder("fe_dog_head", seed + 1, dev), embedder("fe_cat_head", seed + 2, dev))
    if body:
        models += (mask_detector(dev, seed + 3), embedder("fe_dog_body", seed + 4, dev),
                   embedder("fe_cat_body", seed + 5, dev))
    return models


def _keypoint_name(arch: str, variant: str) -> tuple[str, tuple[str, ...]]:
    if arch == "mobile":
        return f"det_keypoint_mobile_{variant}", ("kp_head",)
    return f"det_keypoint_{variant}", ("detector", "kp_head")


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


def mask_detector(device: str | torch.device = "cuda", seed: int = 0,
                  dtype: torch.dtype = torch.float32) -> nn.Module:
    """The body detector, as the JAX ``configs/pipelines.py::mask_pipeline``
    resolves it: ``maskrcnn_resnet50_fpn(num_classes=2,
    box_detections_per_img=3)`` at ``RCNNConfig``'s test budgets (RPN 1000 a
    level into NMS, 1000 out; box NMS 0.5; score threshold 0.05), loading
    the port checkpoint named by ``PFR_MASK_CKPT`` (default
    ``results/mask/checkpoints``; a folder gives its newest
    ``epoch=*-step=*``). Without the variable and without a checkpoint at the
    default, seeded random weights from ``seed``; a ``PFR_MASK_CKPT`` that
    names no checkpoint raises. In eval mode on ``device``, computing in
    ``dtype``."""
    from .engine.checkpoint import load_params

    dev = resolve_device(device)
    mode, det_q, _ = detector_quant("det_mask", ("detector",))
    detector = maskrcnn_resnet50_fpn(num_classes=2, box_detections_per_img=3, quant=det_q,
                                     dtype=dtype)
    ckpt = _checkpoint("PFR_MASK_CKPT", "results/mask/checkpoints")
    if ckpt is None:
        print(f"no mask checkpoint at results/mask/checkpoints: seeded random weights "
              f"(seed {seed})", flush=True)
        init_random_(detector, seed)
    else:
        load_float_state_dict(detector, load_params(ckpt))
    return _served("det_mask", detector, mode, dev)


def keypoint_detector(device: str | torch.device = "cuda", seed: int = 0,
                      variant: str = "prod", dtype: torch.dtype = torch.float32,
                      arch: str | None = None) -> nn.Module:
    """The head detector, as the JAX ``configs/pipelines.py::
    keypoint_pipeline(variant)`` resolves it for the chain and the offline
    transforms: the port checkpoint that ``variant``'s variable in
    :data:`KEYPOINT_VARIANTS` names (``prod``: ``PFR_KEYPOINT_CKPT``, default
    ``results/keypoint/checkpoints``; ``v2``/``v3``/``v4``:
    ``PFR_KEYPOINT_CKPT_V2``/``_V3``/``_V4``; a folder gives its newest
    ``epoch=*-step=*``), loaded into the ``arch`` detector (default
    ``PFR_KEYPOINT_ARCH``) with frozen norms at ``RCNNConfig``'s test budgets
    (the RPN's top 1000 a level into NMS, 1000 an image out) and one
    detection, as the JAX factory builds it. Without the variable and without
    a checkpoint at the default, the serving detector with weights from
    ``seed`` (``serving.serving_detector``, at the serving budgets of 128 and
    16); a variable that names no checkpoint raises. Under
    ``PFR_QUANT_MODE``, the int8 twin (``det_keypoint_{variant}``, or
    ``det_keypoint_mobile_{variant}`` with the ``kp_head`` component alone).
    In eval mode on ``device``, computing in ``dtype``."""
    from .engine.checkpoint import load_params
    from .models.rcnn import keypointrcnn_resnet50_fpn, mobile_net_v3_large_keypoint_rcnn

    if variant not in KEYPOINT_VARIANTS:
        raise ValueError(f"keypoint variant {variant!r}: expected one of "
                         f"{sorted(KEYPOINT_VARIANTS)}")
    dev = resolve_device(device)
    arch = arch or keypoint_arch()
    env, default = KEYPOINT_VARIANTS[variant]
    ckpt = _checkpoint(env, default)
    name, supports = _keypoint_name(arch, variant)
    mode, det_q, kp_q = detector_quant(name, supports)
    if ckpt is None:
        print(f"no keypoint checkpoint at {default}: "
              f"seeded random weights (seed {seed})", flush=True)
        detector = serving_detector(dev, seed, arch, quant=det_q, quant_kp=kp_q, dtype=dtype)
    else:
        detector = (keypointrcnn_resnet50_fpn(num_classes=2, num_keypoints=3, quant=det_q,
                                              quant_kp=kp_q, dtype=dtype) if arch == "resnet50"
                    else mobile_net_v3_large_keypoint_rcnn(frozen_stats=True, quant_kp=kp_q,
                                                           dtype=dtype))
        load_float_state_dict(detector, load_params(ckpt))
    return _served(name, detector, mode, dev)


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
        return fe(round_input(aligned[None] / scale))[0].cpu().numpy()

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
        x = torch.from_numpy(padded).to(dev)[None].float() / scale
        return fe(round_input(x))[0].cpu().numpy()

    return body_pipeline
