"""Detection task controllers (counterpart of the JAX
``engine/detector_controller.py``): ``DetectionController`` (Mask R-CNN, the
body detector) and its subclass ``KeyPointsController`` (keypoint R-CNN, the
head and landmark detector).

``init_state`` builds the model with seeded random weights and its SGD;
``train_step`` turns a batch (the JAX batch contract: ``images (B, H, W, 3)``,
``boxes (B, G, 4)``, ``labels (B, G)`` with 0 the first foreground class,
``valid (B, G)``, and ``masks (B, G, H, W)`` or ``keypoints (B, G, NK, 3)``)
into targets with the label +1 shift (background is class 0), runs the
training forward, sums the loss dict (``SumDetectionLoss``), backpropagates,
and, with ``accumulate_grad_batches = k``, averages the gradients of ``k``
such mini-steps before one update (``optax.MultiSteps``); the update clips if
asked and steps the optimiser at the scheduled rate of its count of updates.
The keypoint controller's ``arch`` picks the model as the JAX keypoint config
does: ``resnet50`` (frozen trunk statistics) or ``mobile`` (MobileNetV3 with
live BatchNorm, whose running statistics every mini-step moves). A model
built with ``dtype=torch.bfloat16`` (``keypoint_model(arch, dtype)``,
``mask_model(dtype)``) trains in it as JAX's training bench does: trunk,
FPN, RPN and heads in bfloat16, its RoIs pooled by K3's and differentiated
by K4's bfloat16 instances, the losses, parameters and SGD in float32.

The eval step runs the model in ``eval()`` (a live-BN trunk normalises with
its running statistics) without gradients, in float32, and puts it back in
``train()``; with masks it pastes each detection's 28 x 28 mask into the
batch's ``(H, W)`` on the detections' device (``ops.masks.paste_masks``).
``run_eval_batch`` brings the detections and the targets (labels +1) to host
numpy, and ``evaluate`` scores them (``detection_metrics``): AP at the
controller's IoU thresholds (0.5, 0.7, 0.9 for masks; 0.5, 0.7 for
keypoints), the top detection's IoU, and the mask IoU or the keypoint
errors. With ``config=`` the model, the optimiser and the loaders come from a
config (``config_presets.build_mask_config``, ``build_keypoint_config``).

With a ``mesh`` (``parallel.create_mesh``) the task is data-parallel:
``init_state`` broadcasts rank 0's weights; ``train_step`` takes this rank's
rows of the global batch (the ``Trainer`` shards it) and this rank's rows of
the global sampler draw, divides the box, mask and keypoint losses by the
whole batch's counts, normalises a live-BN trunk over the whole batch,
averages the gradients over the ranks before ``finish_step``, and returns the
whole batch's losses; ``run_eval_batch`` takes the global batch, runs this
rank's images and gathers the detections in rank order.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import parallel
from ..device import float32_matmuls, resolve_device
from ..losses import sum_detection_loss
from ..models.rcnn import (KEYPOINT_ARCHS, GeneralizedRCNN, frozen_twin,
                           keypointrcnn_resnet50_fpn, maskrcnn_resnet50_fpn,
                           mobile_net_v3_large_keypoint_rcnn)
from ..ops.masks import paste_masks
from ..utils.optim import detection_sgd_optimizer
from ..weights import init_random_
from .detection_metrics import detection_metrics, unpad_detections, unpad_targets
from .train_state import TrainState, finish_step, step_generator


def keypoint_model(arch: str = "resnet50", dtype: torch.dtype = torch.float32
                   ) -> GeneralizedRCNN:
    """The keypoint config's model (JAX ``config_presets.build_keypoint_config
    (arch=...).model()``): the ResNet-50-FPN keypoint R-CNN, or for
    ``"mobile"`` the MobileNetV3-Large one with live BatchNorm at flax
    momentum 0.9 (from-scratch training has no pretrained statistics to
    freeze; the serving twin freezes what it learned, ``rcnn.frozen_twin``).
    ``dtype`` is its compute dtype (JAX's training bench clones the model to
    bfloat16, ``tools/bench_train.py:110-112``); parameters stay float32."""
    if arch == "resnet50":
        return keypointrcnn_resnet50_fpn(num_classes=2, num_keypoints=3, dtype=dtype)
    if arch == "mobile":
        return mobile_net_v3_large_keypoint_rcnn(frozen_stats=False, bn_momentum=0.9,
                                                 dtype=dtype)
    raise ValueError(f"keypoint arch {arch!r}: expected one of {KEYPOINT_ARCHS}")


def mask_model(dtype: torch.dtype = torch.float32) -> GeneralizedRCNN:
    """The Mask R-CNN config's model (JAX ``config_presets.build_mask_config
    ().model()``): ResNet-50-FPN, 2 classes, 3 detections an image, computing
    in ``dtype``."""
    return maskrcnn_resnet50_fpn(num_classes=2, box_detections_per_img=3, dtype=dtype)


class DetectionController:
    """Mask R-CNN task: ``model_fn`` builds the model (by default
    :func:`mask_model`), ``optimizer_fn(params)`` returns ``(optimizer,
    schedule)`` (SGD at lr 5e-3 by default). With ``config``, both come from
    it (``config.model``, ``config.optimizer(config)``), and so do the
    loaders."""

    eval_thresholds = (0.5, 0.7, 0.9)
    with_masks = True
    with_keypoints = False

    def __init__(self, model_fn: Callable[[], GeneralizedRCNN] | None = None,
                 optimizer_fn: Callable = detection_sgd_optimizer,
                 gradient_clip_val: float | None = None, *,
                 config=None, accumulate_grad_batches: int = 1,
                 mesh: parallel.Mesh | None = None):
        if config is not None:
            model_fn, optimizer_fn = config.model, config.optimizer(config)
        if model_fn is None:
            model_fn = mask_model
        self.config = config
        self.mesh = mesh
        self.model_fn = model_fn
        self.optimizer_fn = optimizer_fn
        self.gradient_clip_val = gradient_clip_val
        self.accumulate_grad_batches = accumulate_grad_batches

    @staticmethod
    def targets_from_batch(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
        """Batch -> model targets, labels shifted by +1 (background is 0)."""
        def t(x, dtype):
            return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                                   dtype=dtype).to(device)

        targets = {"labels": t(batch["labels"], torch.int64) + 1,
                   "boxes": t(batch["boxes"], torch.float32),
                   "valid": t(batch["valid"], torch.bool)}
        if "masks" in batch:
            targets["masks"] = t(batch["masks"], torch.float32)
        if "keypoints" in batch:
            targets["keypoints"] = t(batch["keypoints"], torch.float32)
        return targets

    def init_state(self, seed: int = 0, device: str | torch.device = "cuda",
                   model: GeneralizedRCNN | None = None) -> TrainState:
        """Model (seeded random weights unless ``model`` is given), optimiser,
        step 0, and ``seed`` for the samplers' noise."""
        dev = resolve_device(device)
        if model is None:
            model = init_random_(self.model_fn(), seed)
        model = model.to(dev).train()
        parallel.broadcast_module(model, self.mesh)
        optimizer, schedule = self.optimizer_fn(
            [p for p in model.parameters() if p.requires_grad])
        return TrainState(model, optimizer, schedule, seed)

    @float32_matmuls()
    def train_step(self, state: TrainState, batch: dict,
                   sampler_noise: dict | None = None) -> dict[str, float]:
        """One mini-step under ``float32_matmuls`` (TF32 off, bfloat16 products
        summed in float32, the caller's flags back after), the model in its
        compute dtype, the losses in float32; returns the loss and each term
        as floats. The samplers' noise
        is ``sampler_noise`` or drawn from ``step_generator(state.seed,
        state.step)``. The model runs in ``train()``, so a live-BN trunk
        normalises with batch statistics and moves its running statistics in
        every mini-step, as the JAX step's ``mutable=["batch_stats"]``.
        Afterwards each parameter's ``.grad`` holds this mini-step's gradient,
        or on an update the clipped mean that was stepped. Under a mesh,
        ``batch`` and ``sampler_noise`` are this rank's rows, and the
        gradients and the returned losses are the whole batch's."""
        model = state.model.train()
        dev = next(model.parameters()).device
        images = torch.as_tensor(batch["images"], dtype=torch.float32).to(dev)
        targets = self.targets_from_batch(batch, dev)
        state.optimizer.zero_grad(set_to_none=True)
        generator = None if sampler_noise is not None else step_generator(state.seed,
                                                                          state.step)
        with parallel.data_parallel(self.mesh):
            out = sum_detection_loss(model(images, targets, sampler_noise=sampler_noise,
                                           generator=generator))
            out["loss"].backward()
        metrics = {k: float(v.detach()) for k, v in out.items()}
        parallel.all_reduce_gradients(model.parameters(), self.mesh)
        finish_step(state, self.accumulate_grad_batches, self.gradient_clip_val)
        return parallel.all_reduce_mean(metrics, self.mesh, dev)

    # -- evaluation ----------------------------------------------------------
    def make_eval_step(self) -> Callable:
        """``eval_step(state, images) -> detections``: the model in ``eval()``
        under ``torch.no_grad()`` in float32, back in ``train()`` after; with
        ``with_masks`` the masks pasted into the images' ``(H, W)``."""
        paste = self.with_masks

        @float32_matmuls()
        @torch.no_grad()
        def eval_step(state: TrainState, images: torch.Tensor) -> dict[str, torch.Tensor]:
            model = state.model.eval()
            try:
                dets = model(images)
            finally:
                model.train()
            if paste and "masks" in dets:
                dets["masks"] = paste_masks(dets["masks"], dets["boxes"],
                                            tuple(images.shape[1:3]))
            return dets

        return eval_step

    def run_eval_batch(self, eval_step: Callable, state: TrainState, batch: dict) -> dict:
        """One eval batch -> ``{'pred', 'true', 'batch_size'}`` on the host;
        the targets get the training +1 label shift. Under a mesh this rank
        runs its rows and the detections of every rank are gathered in order."""
        dev = next(state.model.parameters()).device
        images = np.asarray(batch["images"])
        local = parallel.shard_batch(images, self.mesh)
        dets = eval_step(state, torch.as_tensor(local, dtype=torch.float32).to(dev))
        dets = {k: parallel.all_gather_rows(v, self.mesh) for k, v in dets.items()}
        true = {
            "boxes": np.asarray(batch["boxes"]),
            "labels": np.asarray(batch["labels"]) + 1,
            "valid": np.asarray(batch["valid"]),
        }
        if "masks" in batch:
            true["masks"] = np.asarray(batch["masks"])
        if "keypoints" in batch:
            true["keypoints"] = np.asarray(batch["keypoints"])
        return {"pred": {k: v.cpu().numpy() for k, v in dets.items()}, "true": true,
                "batch_size": images.shape[0]}

    def evaluate(self, outputs: list[list[dict]], logger=None, epoch: int = 0,
                 prefix: str = "") -> dict[str, dict[str, float]]:
        """``outputs[i]``: the ``run_eval_batch`` results of eval loader ``i``
        (named ``train`` and ``val`` when there are two, else ``val``)."""
        names = ("train", "val") if len(outputs) > 1 else ("val",)
        all_metrics = {}
        for name, batches in zip(names, outputs):
            preds, trues = [], []
            for b in batches:
                preds.extend(unpad_detections(b["pred"], b["batch_size"]))
                trues.extend(unpad_targets(b["true"], b["batch_size"]))
            metrics = detection_metrics(preds, trues, thresholds=self.eval_thresholds,
                                        with_masks=self.with_masks,
                                        with_keypoints=self.with_keypoints)
            all_metrics[name] = metrics
            if logger is not None:
                logger.log_metrics(
                    {f"{prefix}{name} {k}": v for k, v in metrics.items()}, epoch)
            else:
                print(*[f"{name} {k}\t{v}" for k, v in metrics.items()], sep="\n")
        return all_metrics

    # -- data loaders ----------------------------------------------------------
    def train_dataloader(self):
        return self.config.train_dataloader()

    def val_dataloader(self):
        return self.config.val_dataloader()

    def test_dataloader(self):
        dl = self.config.get("test_dataloader")
        return dl() if dl is not None else self.config.val_dataloader()


class KeyPointsController(DetectionController):
    """Keypoint R-CNN task (the JAX ``KeyPointsController``): the same
    machinery with AP at 0.5 and 0.7, no masks and the keypoint errors;
    ``model_fn`` defaults to :func:`keypoint_model` of ``arch``."""

    eval_thresholds = (0.5, 0.7)
    with_masks = False
    with_keypoints = True

    def __init__(self, model_fn: Callable[[], GeneralizedRCNN] | None = None,
                 optimizer_fn: Callable = detection_sgd_optimizer,
                 gradient_clip_val: float | None = None, arch: str = "resnet50", *,
                 config=None, accumulate_grad_batches: int = 1,
                 mesh: parallel.Mesh | None = None):
        if config is None and model_fn is None:
            if arch not in KEYPOINT_ARCHS:
                raise ValueError(f"keypoint arch {arch!r}: expected one of {KEYPOINT_ARCHS}")
            model_fn = lambda: keypoint_model(arch)  # noqa: E731
        super().__init__(model_fn, optimizer_fn, gradient_clip_val, config=config,
                         accumulate_grad_batches=accumulate_grad_batches, mesh=mesh)

    @staticmethod
    def serving_model(state: TrainState) -> GeneralizedRCNN:
        """The frozen serving twin of a live-BN MobileNetV3 state
        (``rcnn.frozen_twin``: its weights and running statistics under
        frozen norms, eval mode)."""
        return frozen_twin(state.model)
