"""A minimal training loop (counterpart of the JAX ``engine/trainer.py``'s
step loop): ``Trainer().fit(controller, batches, max_steps)`` steps over the
batches and logs the loss dict of every step. Datasets, collate, validation,
checkpoints and signals are not ported yet."""

from __future__ import annotations

import json
import time
from typing import Callable, Iterable

from ..device import float32_matmuls
from .train_state import TrainState


class Trainer:
    def __init__(self, log: Callable[[str], None] = print):
        self.log = log
        self.history: list[dict[str, float]] = []

    @float32_matmuls()
    def fit(self, controller, batches: Iterable[dict], max_steps: int,
            state: TrainState | None = None, seed: int = 0,
            device: str = "cuda") -> TrainState:
        """Run up to ``max_steps`` steps, cycling over ``batches``, in float32
        (TF32 off inside, the caller's flags back after)."""
        if state is None:
            state = controller.init_state(seed, device)
        batches = list(batches)
        for i in range(max_steps):
            t0 = time.perf_counter()
            metrics = controller.train_step(state, batches[i % len(batches)])
            metrics["step_s"] = time.perf_counter() - t0
            self.history.append(metrics)
            self.log(json.dumps({"step": state.step, **metrics}))
        return state
