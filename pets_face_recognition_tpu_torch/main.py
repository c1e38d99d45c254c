"""Train from a ``--config`` file (counterpart of the JAX ``main.py``): a
timestamped run directory under the config's ``output`` with a copy of the
config, the metrics logger, then ``configure_trainer(config, logger).fit``.
``--device`` defaults to ``cuda`` and raises without a card; pass ``cpu`` to
run the plain path. Without a controller it trains the feature extractor, as
the JAX ``main.py`` does, in its config's ``compute_dtype``
(``build_fe_config``'s ``"auto"``: bfloat16 on the card, float32 with
``--device cpu``):

    python -m pets_face_recognition_tpu_torch.main \
        --config pets_face_recognition_tpu_torch/configs/fe_smoke.py [--device cpu]

``main_keypoints`` and ``main_detection`` pass the keypoint and Mask R-CNN
controllers. Data-parallel over several processes, one a card: set
``COORDINATOR_ADDRESS=host:port``, ``NUM_PROCESSES`` and ``PROCESS_ID`` in each
(NCCL on the card, ``gloo`` with ``--device cpu``); the config's batch is the
global one, and each process trains on its rows."""

from __future__ import annotations

import argparse
import os
import shutil
from datetime import datetime
from pathlib import Path

from .device import resolve_device
from .engine.logging import MetricsLogger
from .engine.trainer import Trainer, configure_trainer
from .parallel import create_mesh, init_distributed
from .utils import get_config, is_main_process


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True, type=Path,
                        help="Path to config file")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda; cpu runs the "
                             "plain path)")
    return parser.parse_args(argv)


def setup_run(config, config_path: Path) -> MetricsLogger | None:
    """Create the timestamped run dir, copy the config there, build the
    logger (on the main process only)."""
    logger = None
    if is_main_process():
        restime = datetime.now().strftime("%Y%m%d-%H%M%S")
        run_output_root = Path(config.output) / restime
        config.output = run_output_root
        config.checkpoint_path = run_output_root / "checkpoints"
        config.img_dir = run_output_root / "img"
        config.checkpoint_path.mkdir(parents=True, exist_ok=True)
        config.img_dir.mkdir(exist_ok=True)
        shutil.copy2(config_path, run_output_root)

        user = os.environ.get("LOGNAME", os.environ.get("USERNAME", "unknown"))
        logger = MetricsLogger(
            run_output_root,
            run_name=config.get("run_name", f"{user}-default"),
            experiment_name=config.get("experiment_name", "default"),
            use_mlflow=config.get("mlflow_target_uri") is not None,
        )
        logger.log_hyperparams(dict(config.items()))
    return logger


def main(controller_cls=None, argv=None) -> Trainer:
    if controller_cls is None:
        from .engine.controller import Controller as controller_cls
    args = parse_args(argv)
    resolve_device(args.device)
    init_distributed(device=args.device)
    config = get_config(args.config)
    logger = setup_run(config, args.config)
    mesh = create_mesh(device=args.device)
    controller = controller_cls(config=config, mesh=mesh)
    trainer = configure_trainer(config, logger, default_root_dir=config.get("output", "."),
                                device=args.device, mesh=mesh)
    trainer.fit(controller)
    print("Completed!")
    return trainer


if __name__ == "__main__":
    main()
