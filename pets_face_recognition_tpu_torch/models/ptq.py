"""Calibrate -> int8 post-training quantization for serving (counterpart of the
JAX ``models/ptq.py``).

``models/quant.py`` gives the serving models int8 twins over the float
parameters. This module runs the workflow around them:

1. **calibrate**: the float forward over representative inputs, while every
   ``ActQuant`` widens its running max-abs and every ``QuantConv`` snapshots
   its int8 weights (:meth:`PTQServing.calibrate`);
2. the quant state is written when the process exits (:func:`register`,
   :func:`save_quant_state`);
3. **int8**: the same model serves int8 over the state read back
   (:func:`load_quant_state`, :meth:`PTQServing.serve`).

The process-wide contract is read from the environment, as in JAX:

- ``PFR_QUANT_MODE``: ``""`` (float, the default), ``"calibrate"`` or
  ``"int8"``;
- ``PFR_QUANT_STATE``: the state file (default ``quant_state.pkl``), a
  pickle of model name -> {buffer name -> numpy array}, written at exit in
  calibrate mode and read in int8 mode;
- ``PFR_QUANT_COMPONENTS``: a comma subset of ``embedder,detector,kp_head``
  (the default is all three): ``embedder`` the four embedders' trunks,
  ``detector`` the R-CNN trunk and RPN at the shipping scope ``rpn``,
  ``kp_head`` the keypoint head's convolutions.

Model names are the JAX package's: ``det_keypoint_{variant}``,
``det_keypoint_mobile_{variant}``, ``det_mask``, ``fe_{dog,cat}_{head,body}``.
"""

from __future__ import annotations

import atexit
import os
import pickle
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..device import float32_matmuls
from .quant import quant_state, seed_calibration, set_quant_mode

QUANT_MODE_ENV = "PFR_QUANT_MODE"
QUANT_STATE_ENV = "PFR_QUANT_STATE"
QUANT_COMPONENTS_ENV = "PFR_QUANT_COMPONENTS"
_DEFAULT_STATE = "quant_state.pkl"
_DEFAULT_COMPONENTS = "embedder,detector,kp_head"


def quant_mode() -> str:
    mode = os.environ.get(QUANT_MODE_ENV, "")
    if mode not in ("", "calibrate", "int8"):
        raise ValueError(f"{QUANT_MODE_ENV}={mode!r}: expected '', 'calibrate'"
                         " or 'int8'")
    return mode


def quant_components() -> set[str]:
    comps = {c.strip() for c in os.environ.get(
        QUANT_COMPONENTS_ENV, _DEFAULT_COMPONENTS).split(",") if c.strip()}
    unknown = comps - {"embedder", "detector", "kp_head"}
    if unknown:
        raise ValueError(f"{QUANT_COMPONENTS_ENV}: unknown {sorted(unknown)}")
    return comps


def _state_path() -> Path:
    return Path(os.environ.get(QUANT_STATE_ENV, _DEFAULT_STATE))


class PTQServing:
    """One model's calibrate / int8 workflow over fixed weights.

    ``model`` is a quant twin (built with ``quant=`` / ``quant_kp=``) holding
    the checkpoint's or the seeded weights, in eval mode on its device. Its
    quant state starts where the JAX ``PTQServing``'s ``init`` on zeros
    leaves it (``quant.seed_calibration``: every scale at the 1e-6 floor,
    ``seen`` set), so calibration batches set the scales to their running
    max, whatever the serving input size.
    """

    def __init__(self, name: str, model: nn.Module):
        self.name = name
        self.model = model
        if not quant_state(model):
            raise ValueError(f"{name}: the model has no quant modules")
        seed_calibration(model)

    @torch.inference_mode()
    @float32_matmuls()
    def calibrate(self, x: torch.Tensor):
        """The float forward (its output is the float model's) that folds the
        observed ranges into the quant state (a running max across calls)."""
        return set_quant_mode(self.model, "calibrate")(x)

    @torch.inference_mode()
    @float32_matmuls()
    def serve(self, x: torch.Tensor):
        """The int8 forward over the current quant state."""
        return set_quant_mode(self.model, "int8")(x)

    def quant_numpy(self) -> dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in quant_state(self.model).items()}

    def load_quant(self, tree: dict[str, np.ndarray]) -> None:
        ref = {k: (v.shape, v.dtype) for k, v in self.quant_numpy().items()}
        got = {k: (np.shape(v), np.asarray(v).dtype) for k, v in tree.items()}
        if ref != got:
            raise ValueError(
                f"{self.name}: quant-state tree mismatch — the saved state "
                f"was calibrated under a different model configuration "
                f"(e.g. a different {QUANT_COMPONENTS_ENV}). Re-run "
                f"calibrate mode with the SAME component subset and state "
                f"path as this int8 run.")
        state = quant_state(self.model)
        with torch.no_grad():
            for k, v in tree.items():
                state[k].copy_(torch.from_numpy(np.array(v)))


# -- registry: every PTQServing built under calibrate mode saves on exit ----
_REGISTRY: dict[str, PTQServing] = {}
_atexit_installed = False


def register(runner: PTQServing) -> PTQServing:
    global _atexit_installed
    _REGISTRY[runner.name] = runner
    if quant_mode() == "calibrate" and not _atexit_installed:
        atexit.register(save_quant_state)
        _atexit_installed = True
    return runner


def save_quant_state(path: Path | None = None) -> Path:
    path = Path(path) if path is not None else _state_path()
    state = {name: r.quant_numpy() for name, r in _REGISTRY.items()}
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(state, f)
    # which submodules of each model were calibrated: a detector entry that
    # holds only its keypoint head's points means its trunk and RPN never ran
    # int8 (a stray PFR_QUANT_COMPONENTS)
    for name in sorted(state):
        tops = sorted({k.split(".", 1)[0] for k in state[name]})
        print(f"PTQ: {name}: calibrated submodules {tops}")
    print(f"PTQ: saved quant state for {sorted(state)} -> {path}")
    return path


def load_quant_state(name: str, path: Path | None = None) -> dict[str, np.ndarray]:
    path = Path(path) if path is not None else _state_path()
    if not path.exists():
        raise FileNotFoundError(
            f"PFR_QUANT_MODE=int8 requires a calibrated quant state at "
            f"{path} — run the same command with PFR_QUANT_MODE=calibrate "
            f"first (see models/ptq.py)")
    with open(path, "rb") as f:
        state = pickle.load(f)
    if name not in state:
        raise KeyError(f"{path} has no quant state for {name!r} "
                       f"(has {sorted(state)})")
    return state[name]


class PTQModelFn(nn.Module):
    """A model facade that dispatches on the process quant mode, usable where
    the float model is (``Preproc*``, the pipelines, ``EmbeddingService``):

    - ``"calibrate"``: every call runs the float forward and calibrates;
    - ``"int8"``: the saved quant state is loaded once, every call serves int8.
    """

    def __init__(self, runner: PTQServing, mode: str):
        super().__init__()
        self.runner = register(runner)
        self.model = runner.model
        self.mode = mode
        if mode == "int8":
            runner.load_quant(load_quant_state(runner.name))

    def forward(self, x: torch.Tensor):
        if self.mode == "calibrate":
            return self.runner.calibrate(x)
        return self.runner.serve(x)
