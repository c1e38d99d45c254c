"""Evaluate a trained feature extractor (counterpart of the JAX
``eval_fe_cat_head_sgd.py`` and ``eval_fe_dog_head_sgd.py``): build the
config's FE wrapper, merge a port checkpoint into it (non-strict, so a
checkpoint without the margin head ``add_margin`` loads; the newest
``epoch=*-step=*`` when ``--ckpt`` is a folder) and evaluate it as
``Trainer.test`` does over the config's test (else validation) loader: ROC
AUC, accuracy at the optimal threshold, Recall@K and the rest of
``verification_metrics``. The embedder computes in the config's
``compute_dtype`` for the device (``"auto"``: bfloat16 on the card); a
checkpoint holds float32 tensors whatever dtype trained it.

    python -m pets_face_recognition_tpu_torch.eval_fe --species cat|dog \\
        --ckpt <run>/checkpoints [--config <config>] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .device import resolve_device
from .engine.checkpoint import load_params, merge_params
from .engine.controller import Controller
from .engine.trainer import Trainer
from .eval_landmark import resolve_checkpoint
from .parallel import create_mesh, init_distributed
from .utils import get_config

CONFIGS = Path(__file__).resolve().parent / "configs"
DEFAULT_CONFIGS = {"cat": CONFIGS / "cat_fe_head.py", "dog": CONFIGS / "fe_dogs_config.py"}


def predict(config_path: str | Path, ckpt_path: str | Path, device: str = "cuda"
            ) -> tuple[Controller, list[dict]]:
    """The config's controller and, for each batch of its test (else
    validation) loader, ``run_eval_batch``'s embeddings, labels and indices
    from the checkpoint's weights on ``device``."""
    dev = resolve_device(device)
    config = get_config(config_path)
    init_distributed(device=dev)
    mesh = create_mesh(device=dev)
    controller = Controller(config, mesh=mesh)
    trainer = Trainer(config=config, enable_checkpointing=False,
                      default_root_dir=config.get("output", "."), device=device, mesh=mesh)
    state = controller.init_state(0, dev)
    merge_params(state.model, load_params(ckpt_path, dev))
    return controller, trainer.predict(controller, state)


def evaluate(config_path: str | Path, ckpt_path: str | Path, device: str = "cuda"
             ) -> dict[str, dict[str, float]]:
    """``Trainer.test``'s metrics: :func:`predict`, then the controller's
    ``evaluate`` over the config's pair generator."""
    controller, outputs = predict(config_path, ckpt_path, device)
    return controller.evaluate([outputs], prefix="test ")


def main(argv=None) -> dict[str, dict[str, float]]:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="The JAX package's orbax checkpoints (configs/to_reproduce/) cannot be "
               "read here: they need JAX and tensorstore. Train with "
               "pets_face_recognition_tpu_torch.main to make a port checkpoint.")
    parser.add_argument("--species", choices=sorted(DEFAULT_CONFIGS), default="cat",
                        help="picks the default config (cat: cat_fe_head, dog: fe_dogs_config)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--ckpt", required=True,
                        help="a port checkpoint, or a folder holding epoch=*-step=* ones")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    config = args.config or DEFAULT_CONFIGS[args.species]
    return evaluate(config, resolve_checkpoint(args.ckpt), device=args.device)


if __name__ == "__main__":
    main()
