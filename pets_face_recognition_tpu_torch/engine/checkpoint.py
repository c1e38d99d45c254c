"""Checkpoints of the port (counterpart of the JAX ``engine/checkpoint.py``):
one ``torch.save`` file a checkpoint, named ``epoch=N-step=M`` under a
``checkpoints/`` folder as the JAX package names its orbax folders, so that
the eval entry points find the newest the same way.

A checkpoint holds the model's ``state_dict`` (parameters and buffers: the
frozen or running BatchNorm statistics, the JAX ``params`` and
``batch_stats``), the optimiser's ``state_dict`` (momentum buffers), the
partial gradient average of an unfinished accumulation (``accum``, None
outside one), the step and the epoch: what the JAX ``opt_state`` and ``step``
carry. The JAX package's orbax checkpoints cannot be read here (they need
tensorstore).
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any

import torch

from .train_state import TrainState

_NAME = re.compile(r"epoch=(\d+)-step=(\d+)")


def save_checkpoint(ckpt_dir: str | Path, state: TrainState, epoch: int) -> Path:
    """Save ``state`` as ``<ckpt_dir>/epoch=E-step=S`` (written whole, then
    renamed into place); returns the path."""
    ckpt_dir = Path(ckpt_dir).resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    return write_payload(ckpt_dir / f"epoch={epoch}-step={state.step}", {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "accum": state.accum,
        "step": int(state.step),
        "epoch": int(epoch),
    })


def write_payload(path: Path, payload: dict[str, Any]) -> Path:
    """``torch.save`` a checkpoint payload at ``path``, written whole, then
    renamed into place; returns the path."""
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def load_checkpoint(path: str | Path, map_location: str | torch.device = "cpu"
                    ) -> dict[str, Any]:
    """The raw payload, its tensors on ``map_location``."""
    return torch.load(Path(path), map_location=map_location, weights_only=True)


def load_params(path: str | Path, map_location: str | torch.device = "cpu"
                ) -> dict[str, torch.Tensor]:
    """Just the model's ``state_dict``, for inference."""
    return load_checkpoint(path, map_location)["model"]


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    """The highest-step ``epoch=*-step=*`` entry under ``ckpt_dir``."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best, best_step = None, -1
    for p in ckpt_dir.iterdir():
        m = _NAME.fullmatch(p.name)
        if m and int(m.group(2)) > best_step:
            best, best_step = p, int(m.group(2))
    return best


def merge_params(model: torch.nn.Module, loaded: dict[str, torch.Tensor]) -> torch.nn.Module:
    """Non-strict merge: overwrite the tensors of ``model`` that ``loaded``
    holds, keep the others, ignore names ``model`` lacks; a shape mismatch
    raises (``load_state_dict(strict=False)``, as the JAX ``merge_params``)."""
    model.load_state_dict(loaded, strict=False)
    return model


def restore_checkpoint(state: TrainState, path: str | Path) -> int:
    """Load a checkpoint into ``state`` in place (model, optimiser, partial
    accumulation, step; strict); returns the checkpoint's epoch."""
    dev = next(state.model.parameters()).device
    payload = load_checkpoint(path, dev)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.accum = payload["accum"]
    state.step = int(payload["step"])
    return int(payload["epoch"])
