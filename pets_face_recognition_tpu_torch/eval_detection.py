"""Evaluate a trained Mask R-CNN body detector (counterpart of the JAX
``eval_detection.py``): build the config's model, merge a port checkpoint
into it (non-strict; the newest ``epoch=*-step=*`` when ``--ckpt`` is a
folder) and run ``Trainer.test`` over the config's test (else validation)
loader: AP 50 / 70 / 90, the top detection's IoU and the masks' mean IoU,
the masks pasted on the device.

    python -m pets_face_recognition_tpu_torch.eval_detection \\
        [--config <config>] --ckpt <run>/checkpoints [--device cpu]

The JAX package's orbax checkpoints cannot be read here (they need
tensorstore).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .device import resolve_device
from .engine.detector_controller import DetectionController
from .eval_landmark import evaluate as _evaluate
from .eval_landmark import resolve_checkpoint

DEFAULT_CONFIG = Path(__file__).resolve().parent / "configs" / "mask_rcnn_config.py"


def evaluate(config_path: str | Path, ckpt_path: str | Path, device: str = "cuda"
             ) -> dict[str, dict[str, float]]:
    return _evaluate(config_path, ckpt_path, DetectionController, device)


def main(argv=None) -> dict[str, dict[str, float]]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=str(DEFAULT_CONFIG))
    parser.add_argument("--ckpt", required=True,
                        help="a checkpoint, or a folder holding epoch=*-step=* ones")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    return evaluate(args.config, resolve_checkpoint(args.ckpt), device=args.device)


if __name__ == "__main__":
    main()
