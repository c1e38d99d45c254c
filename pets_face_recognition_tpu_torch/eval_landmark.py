"""Evaluate a trained keypoint R-CNN head+landmark detector (counterpart of
the JAX ``eval_landmark.py`` and ``eval_detection.py::evaluate``): build the
config's model, merge a port checkpoint into it (non-strict; the newest
``epoch=*-step=*`` when ``--ckpt`` is a folder) and run ``Trainer.test``
over the config's test (else validation) loader: AP 50 / 70, the top
detection's IoU and the keypoint errors.

    python -m pets_face_recognition_tpu_torch.eval_landmark --config <config> \\
        --ckpt <run>/checkpoints [--device cpu]

The JAX package's orbax checkpoints cannot be read here (they need
tensorstore).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .device import resolve_device
from .engine.checkpoint import latest_checkpoint, load_params, merge_params
from .engine.detector_controller import KeyPointsController
from .engine.trainer import Trainer
from .utils import get_config

DEFAULT_CONFIG = Path(__file__).resolve().parent / "configs" / "keypoints_config.py"


def evaluate(config_path: str | Path, ckpt_path: str | Path,
             controller_cls=KeyPointsController, device: str = "cuda"
             ) -> dict[str, dict[str, float]]:
    dev = resolve_device(device)
    config = get_config(config_path)
    controller = controller_cls(config=config)
    trainer = Trainer(config=config, enable_checkpointing=False,
                      default_root_dir=config.get("output", "."), device=device)
    state = controller.init_state(0, dev)
    merge_params(state.model, load_params(ckpt_path, dev))
    return trainer.test(controller, state)


def resolve_checkpoint(ckpt: str | Path) -> Path:
    """A checkpoint file, or the newest one in a folder (raises if none)."""
    ckpt = Path(ckpt)
    if ckpt.is_dir():
        found = latest_checkpoint(ckpt)
        if found is None:
            raise FileNotFoundError(f"no epoch=*-step=* checkpoint in {ckpt}")
        return found
    return ckpt


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
