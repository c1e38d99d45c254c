"""Precise BN for a MobileNetV3 keypoint R-CNN checkpoint (counterpart of the
JAX ``tools/recalibrate_bn.py``).

The MobileNetV3 trunk's live BatchNorm keeps its running statistics at a
momentum meant for long training; after a short smoke fit they lag the
activations, and a detector that has learned its task can score nothing in
eval mode. Precise BN recomputes the running statistics over training
photos after training, with every weight held fixed: ``--passes``
train-mode passes of the trunk alone (the detector built as
``mobile_net_v3_large_keypoint_rcnn(frozen_stats=False, bn_momentum=0.5)``,
so about 20 passes bring the running averages to the data), each over
``--batch`` photos of ``CatLMDDataset`` drawn by
``RandomState(--seed).choice(len(ds), batch, replace=False)`` and collated
at ``--image-size`` by ``DetectionCollate(max_boxes=2, num_keypoints=3)``.
The statistics follow ``LiveBatchNorm2d`` (flax's conventions: the biased
batch variance, momentum as the old statistics' weight); no gradient is
taken and no optimiser steps.

    python -m pets_face_recognition_tpu_torch.recalibrate_bn \\
        --ckpt results_smoke/<run>/checkpoints [--data <CAT_DATASET>] [--passes 24] \\
        [--batch 4] [--image-size 320] [--seed 0] [--device cuda|cpu]

``--ckpt`` is a port checkpoint or a folder (its newest ``epoch=*-step=*``);
a ``state_dict`` whose every key starts with ``model.`` (a training
wrapper's) is read under that prefix and written back with it. The result is
the sibling ``epoch=E-step=S+1``: the source's payload with only the running
statistics new (parameters, optimiser state and epoch unchanged), which
``engine.checkpoint.latest_checkpoint`` then prefers. ``--data`` defaults to
the committed 40-photo miniature. Departure from JAX: its tool runs on the
CPU unless given ``--tpu``; this one runs on the card unless given
``--device cpu``, as every entry point of the port.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .data_loading.lmd_dataset import CatLMDDataset
from .device import float32_matmuls, resolve_device
from .engine.checkpoint import latest_checkpoint, load_checkpoint, write_payload
from .models.rcnn import mobile_net_v3_large_keypoint_rcnn
from .utils.collate import DetectionCollate

DEFAULT_DATA = Path(__file__).resolve().parent / "testdata" / "CAT_DATASET"
PREFIX = "model."
STATS = ("running_mean", "running_var")


def source_checkpoint(ckpt: str | Path) -> Path:
    """``ckpt``, or a folder's newest ``epoch=*-step=*``; exits when there is none."""
    path = Path(ckpt)
    if path.is_dir() and not path.name.startswith("epoch="):
        path = latest_checkpoint(path)
        if path is None:
            raise SystemExit(f"no epoch=*-step=* checkpoint under {ckpt}")
    return path


@torch.no_grad()
@float32_matmuls()
def recalibrated_stats(state_dict: dict[str, torch.Tensor], data: str | Path,
                       passes: int = 24, batch: int = 4, image_size: int = 320, seed: int = 0,
                       device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """The trunk's running statistics (``state_dict`` names, on the CPU) after
    ``passes`` train-mode trunk passes over ``data``, from the statistics of
    the detector's ``state_dict`` (strict)."""
    dev = resolve_device(device)
    model = mobile_net_v3_large_keypoint_rcnn(frozen_stats=False, bn_momentum=0.5)
    model.load_state_dict(state_dict, strict=True)
    model.eval().requires_grad_(False).to(dev)
    trunk = model.backbone.body.train()
    ds = CatLMDDataset(str(data))
    collate = DetectionCollate((image_size, image_size), max_boxes=2, num_keypoints=3)
    rng = np.random.RandomState(seed)
    for _ in range(passes):
        idx = rng.choice(len(ds), batch, replace=False)
        images = collate([ds[int(i)] for i in idx])["images"]
        trunk(torch.from_numpy(images).to(dev).permute(0, 3, 1, 2))
    return {k: v.detach().cpu() for k, v in model.state_dict().items()
            if k.rsplit(".", 1)[-1] in STATS}


def write_sibling(path: Path, payload: dict, state_dict: dict[str, torch.Tensor],
                  wrapped: bool) -> Path:
    """Save ``payload`` with ``state_dict`` (under the wrapper's prefix when
    ``wrapped``) and the next step as ``epoch=E-step=S+1`` beside ``path``."""
    new = dict(payload)
    new["model"] = {PREFIX + k: v for k, v in state_dict.items()} if wrapped else state_dict
    new["step"] = int(payload["step"]) + 1
    return write_payload(path.parent / f"epoch={int(payload['epoch'])}-step={new['step']}", new)


def main(argv: list[str] | None = None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", type=Path, required=True,
                    help="checkpoints folder (or one epoch=*-step=* file)")
    ap.add_argument("--data", type=Path, default=DEFAULT_DATA)
    ap.add_argument("--passes", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=320)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    resolve_device(args.device)
    path = source_checkpoint(args.ckpt)
    payload = load_checkpoint(path)
    sd = payload["model"]
    wrapped = bool(sd) and all(k.startswith(PREFIX) for k in sd)
    if wrapped:
        sd = {k[len(PREFIX):]: v for k, v in sd.items()}
    stats = recalibrated_stats(sd, args.data, args.passes, args.batch, args.image_size,
                               args.seed, args.device)
    out = write_sibling(path, payload, {**sd, **stats}, wrapped)
    print(f"recalibrated {args.passes} passes -> {out}")
    return out


if __name__ == "__main__":
    main()
