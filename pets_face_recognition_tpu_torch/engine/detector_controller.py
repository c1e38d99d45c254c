"""Keypoint R-CNN training controller (counterpart of the JAX
``engine/detector_controller.py::KeyPointsController``).

``init_state`` builds the model with seeded random weights and its SGD;
``train_step`` turns a batch (the JAX batch contract: ``images (B, H, W, 3)``,
``boxes (B, G, 4)``, ``labels (B, G)`` with 0 the first foreground class,
``valid (B, G)``, ``keypoints (B, G, NK, 3)``) into targets with the label +1
shift (background is class 0), runs the training forward, sums the loss dict
(``SumDetectionLoss``), backpropagates, clips if asked and steps the
optimiser at the scheduled rate. After a step each parameter's ``.grad`` holds
that step's gradient. ``arch`` picks the model as the JAX keypoint config
does: ``resnet50`` (frozen trunk statistics) or ``mobile`` (MobileNetV3 with
live BatchNorm, whose running statistics the step moves). The eval step and
the AP metrics are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..device import float32_matmuls, resolve_device
from ..losses import sum_detection_loss
from ..models.rcnn import (KEYPOINT_ARCHS, GeneralizedRCNN, frozen_twin,
                           keypointrcnn_resnet50_fpn, mobile_net_v3_large_keypoint_rcnn)
from ..utils.optim import (clip_by_global_norm_, detection_sgd_optimizer,
                           set_learning_rate)
from ..weights import init_random_
from .train_state import TrainState


def keypoint_model(arch: str = "resnet50") -> GeneralizedRCNN:
    """The keypoint config's model (JAX ``config_presets.build_keypoint_config
    (arch=...).model()``): the ResNet-50-FPN keypoint R-CNN, or for
    ``"mobile"`` the MobileNetV3-Large one with live BatchNorm at flax
    momentum 0.9 (from-scratch training has no pretrained statistics to
    freeze; the serving twin freezes what it learned, ``rcnn.frozen_twin``)."""
    if arch == "resnet50":
        return keypointrcnn_resnet50_fpn(num_classes=2, num_keypoints=3)
    if arch == "mobile":
        return mobile_net_v3_large_keypoint_rcnn(frozen_stats=False, bn_momentum=0.9)
    raise ValueError(f"keypoint arch {arch!r}: expected one of {KEYPOINT_ARCHS}")


class KeyPointsController:
    """Keypoint R-CNN task: ``model_fn`` builds the model (by default
    :func:`keypoint_model` of ``arch``), ``optimizer_fn(params)`` returns
    ``(optimizer, schedule)`` (the keypoint config's SGD, lr 5e-3, by
    default)."""

    def __init__(self, model_fn: Callable[[], GeneralizedRCNN] | None = None,
                 optimizer_fn: Callable = detection_sgd_optimizer,
                 gradient_clip_val: float | None = None, arch: str = "resnet50"):
        if model_fn is None:
            if arch not in KEYPOINT_ARCHS:
                raise ValueError(f"keypoint arch {arch!r}: expected one of {KEYPOINT_ARCHS}")
            model_fn = lambda: keypoint_model(arch)  # noqa: E731
        self.model_fn = model_fn
        self.optimizer_fn = optimizer_fn
        self.gradient_clip_val = gradient_clip_val

    @staticmethod
    def targets_from_batch(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
        """Batch -> model targets, labels shifted by +1 (background is 0)."""
        def t(x, dtype):
            return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                                   dtype=dtype).to(device)

        targets = {"labels": t(batch["labels"], torch.int64) + 1,
                   "boxes": t(batch["boxes"], torch.float32),
                   "valid": t(batch["valid"], torch.bool)}
        if "keypoints" in batch:
            targets["keypoints"] = t(batch["keypoints"], torch.float32)
        return targets

    def init_state(self, seed: int = 0, device: str | torch.device = "cuda",
                   model: GeneralizedRCNN | None = None) -> TrainState:
        """Model (seeded random weights unless ``model`` is given), optimiser,
        step 0 and a CPU sampler generator seeded with ``seed``."""
        dev = resolve_device(device)
        if model is None:
            model = init_random_(self.model_fn(), seed)
        model = model.to(dev).train()
        optimizer, schedule = self.optimizer_fn(
            [p for p in model.parameters() if p.requires_grad])
        return TrainState(model, optimizer, schedule, torch.Generator().manual_seed(seed))

    @staticmethod
    def serving_model(state: TrainState) -> GeneralizedRCNN:
        """The frozen serving twin of a live-BN MobileNetV3 state
        (``rcnn.frozen_twin``: its weights and running statistics under
        frozen norms, eval mode)."""
        return frozen_twin(state.model)

    @float32_matmuls()
    def train_step(self, state: TrainState, batch: dict,
                   sampler_noise: dict | None = None) -> dict[str, float]:
        """One step in float32 (TF32 off inside, the caller's flags back after);
        returns the loss and each term as floats. The model runs in
        ``train()``, so a live-BN trunk normalises with batch statistics and
        moves its running statistics once a step, as the JAX step's
        ``mutable=["batch_stats"]``."""
        model = state.model.train()
        dev = next(model.parameters()).device
        images = torch.as_tensor(batch["images"], dtype=torch.float32).to(dev)
        targets = self.targets_from_batch(batch, dev)
        state.optimizer.zero_grad(set_to_none=True)
        out = sum_detection_loss(model(images, targets, sampler_noise=sampler_noise,
                                       generator=state.generator))
        out["loss"].backward()
        if self.gradient_clip_val:
            clip_by_global_norm_(model.parameters(), self.gradient_clip_val)
        set_learning_rate(state.optimizer, state.schedule(state.step))
        state.optimizer.step()
        state.step += 1
        return {k: float(v.detach()) for k, v in out.items()}
