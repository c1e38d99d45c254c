"""Drive the alternate R-CNN factories once each: the eval forward, one
training step and the warm eval time.

    python -m pets_face_recognition_tpu_torch.drive_alt_factories [--size 256]
        [--only NAME ...] [--device cuda|cpu]

The counterpart of the JAX package's ``tools/drive_alt_factories.py``. For each
factory, with seeded random weights (``weights.init_random_``) and the tool's
``small`` RPN and box budgets (the JAX tool does not drive the Faster R-CNN,
whose 100 detections need 128 test proposals, the tool's pre-NMS count, where
the others keep 64): a B = 2 batch of uniform images (Swin at
224 x 224, its window tiling; the others at ``--size``) with the tool's 2
boxes an image and, for the keypoint factories, 3 keypoints a box (scaled down
only for images under 192 pixels, where the tool's boxes would not fit); the
eval forward (valid detections, finite boxes); one training step (the loss
dict summed as ``SumDetectionLoss`` sums it, then backward: the loss and the
gradients' absolute sum); and the warm eval ms, the best of 3 calls on fresh
inputs. Prints one JSON line a factory, then ``{"driven": [...]}``. A
non-finite loss or a zero gradient exits 1. Runs on the card unless
``--device cpu``, under ``float32_matmuls``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Callable

import numpy as np
import torch

from .device import float32_matmuls, resolve_device
from .losses.losses import sum_detection_loss
from .models import rcnn
from .weights import init_random_

# the JAX tool's reduced budgets
SMALL = dict(rpn_pre_nms_top_n_train=256, rpn_post_nms_top_n_train=128,
             rpn_pre_nms_top_n_test=128, rpn_post_nms_top_n_test=64,
             rpn_batch_size_per_image=64, box_batch_size_per_image=64)
# name -> (factory, keypoint targets, fixed image side or None for --size, budgets)
FACTORIES: dict[str, tuple[Callable[..., rcnn.GeneralizedRCNN], bool, int | None, dict]] = {
    "swin_tiny_keypoint_rcnn": (rcnn.swin_tiny_keypoint_rcnn, True, 224, SMALL),
    "fasterrcnn_resnet50_fpn": (rcnn.fasterrcnn_resnet50_fpn, False, None,
                                dict(SMALL, rpn_post_nms_top_n_test=128)),
    "mobile_net_v3_large_rcnn": (rcnn.mobile_net_v3_large_rcnn, False, None, SMALL),
    "convnetx_tiny_rcnn": (rcnn.convnetx_tiny_rcnn, False, None, SMALL),
    "convnext_tiny_keypoint_rcnn": (rcnn.convnext_tiny_keypoint_rcnn, True, None, SMALL),
}
B, G = 2, 2


class DriveError(RuntimeError):
    """A factory's drive gave a non-finite value or no gradient."""


def batch(size: int, with_kp: bool, rng: np.random.RandomState) -> tuple[np.ndarray, dict]:
    """The tool's images and targets: boxes ``(24, 24, 120, 120)`` and ``(60,
    60, 180, 180)``, label 1, keypoints uniform in [40, 160], all scaled by
    ``size / 192`` under 192 pixels."""
    scale = min(1.0, size / 192)
    images = rng.rand(B, size, size, 3).astype(np.float32)
    boxes = np.tile(np.array([[24.0, 24.0, 120.0, 120.0], [60.0, 60.0, 180.0, 180.0]],
                             np.float32) * scale, (B, 1, 1))
    targets = {"boxes": boxes, "labels": np.ones((B, G), np.int32),
               "valid": np.ones((B, G), bool)}
    if with_kp:
        kp = np.zeros((B, G, 3, 3), np.float32)
        kp[..., :2] = rng.uniform(40, 160, (B, G, 3, 2)) * scale
        kp[..., 2] = 1.0
        targets["keypoints"] = kp
    return images, targets


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@float32_matmuls()
def drive(name: str, build: Callable[[], rcnn.GeneralizedRCNN], size: int, with_kp: bool,
          device: str | torch.device = "cuda", seed: int = 0, steps: int = 1,
          eval_repeats: int = 3) -> dict:
    """Build ``build()`` on ``device``; run the eval forward on a B = 2 batch,
    ``steps`` training steps (forward, summed loss, backward; no update),
    then ``eval_repeats`` timed eval calls on fresh inputs. The model's
    weights are ``build()``'s: seed them there. Returns the factory's record
    (``eval_dets``, ``train_loss``, ``grad_abs_sum``, ``eval_ms``, the
    seconds of the first calls and each step's ms); raises :class:`DriveError`
    on non-finite boxes or loss, or a zero gradient."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    images, targets = batch(size, with_kp, rng)
    x = torch.from_numpy(images).to(dev)
    tg = {k: torch.from_numpy(v).to(dev) for k, v in targets.items()}
    out: dict = {"factory": name, "size": size, "device": str(dev)}

    t0 = time.perf_counter()
    model = build().to(dev)
    _sync(dev)
    out["build_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with torch.no_grad():
        dets = model(x)
    _sync(dev)
    out["eval_first_s"] = time.perf_counter() - t0
    valid = dets["valid"]
    if not bool(torch.isfinite(dets["boxes"][valid]).all()):
        raise DriveError(f"{name}: non-finite boxes among valid detections")
    out["eval_dets"] = int(valid.sum())

    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    step_ms = []
    for _ in range(steps):
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        losses = sum_detection_loss(model(x, tg, generator=gen))
        losses["loss"].backward()
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = step_ms
    out["train_losses"] = {k: float(v.detach()) for k, v in losses.items()}
    out["train_loss"] = loss = out["train_losses"]["loss"]
    grad = sum(float(p.grad.abs().sum()) for p in model.parameters() if p.grad is not None)
    out["grad_abs_sum"] = grad
    if not math.isfinite(loss):
        raise DriveError(f"{name}: non-finite loss {loss}")
    if not (math.isfinite(grad) and grad > 0):
        raise DriveError(f"{name}: bad gradients, absolute sum {grad}")

    times = []
    for _ in range(eval_repeats):
        xi = torch.from_numpy(rng.rand(B, size, size, 3).astype(np.float32)).to(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            d = model(xi)
        float(d["scores"].sum())
        times.append(time.perf_counter() - t0)
    out["eval_ms"] = min(times) * 1e3
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256, help="image side of all but Swin")
    ap.add_argument("--only", nargs="*", default=None, choices=sorted(FACTORIES),
                    help="drive these factories alone")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    driven = []
    for name, (factory, with_kp, fixed, budgets) in FACTORIES.items():
        if args.only and name not in args.only:
            continue
        build = lambda f=factory, b=budgets: init_random_(f(**b), 0)  # noqa: E731
        try:
            rec = drive(name, build, fixed or args.size, with_kp, args.device)
        except DriveError as e:
            print(f"drive_alt_factories: {e}", file=sys.stderr)
            return 1
        print(json.dumps(rec), flush=True)
        driven.append(name)
    print(json.dumps({"driven": driven}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
