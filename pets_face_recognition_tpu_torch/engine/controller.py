"""Feature-extractor task controller (counterpart of the JAX
``engine/controller.py::Controller``), against the interface the port's
``Trainer`` calls.

From the config (``config_presets.build_fe_config``): ``model(device)`` builds
the embedder for the device it will run on (in its ``compute_dtype``),
``loss(config, model)`` wraps it in ``SoftmaxBasedMetricLearning``
(the head ``add_margin``), ``optimizer(config)`` returns the factory
``model -> (optimizer, schedule)``, and the loaders, ``pair_generator(i)``,
``similarity_f``, ``thrs``, ``far_thr``, ``frr_thr`` and ``k`` come from it too.

- ``init_state(seed, device)``: the wrapper with seeded random weights,
  its optimiser, step 0;
- ``train_step``: the wrapper in ``train()`` (live BatchNorm: batch
  statistics, the running ones moved, as JAX's ``mutable=["batch_stats"]``),
  the loss backpropagated, clipping and accumulation as the detector's, the
  update at the scheduled rate; returns ``loss`` and ``train_acc`` (the
  share of rows whose margin logits' argmax is the label);
- ``make_eval_step`` / ``run_eval_batch``: embeddings in ``eval()`` without
  gradients, to host numpy with the labels and dataset indices;
- ``evaluate``: per validation loader, the embeddings sorted by index, the
  pairs' similarities over the generator's ``corrected_indices``,
  ``verification_metrics`` and ``recall_at_k``.

With a ``mesh`` (``parallel.create_mesh``) the task is data-parallel:
``init_state`` broadcasts rank 0's weights, ``train_step`` takes this rank's
rows of the global batch (the ``Trainer`` shards it), normalises the live
BatchNorm over the whole batch, averages the gradients over the ranks before
``finish_step`` clips and steps, and returns the whole batch's metrics;
``run_eval_batch`` takes the global batch, embeds this rank's rows and
gathers the embeddings in rank order.

Every step runs under ``float32_matmuls`` (TF32 off, bfloat16 products summed
in float32): the embedder's trunk in its compute dtype, ``fc``, the margin
head and the loss in float32, parameters and optimiser state float32. Where the JAX ``evaluate``
draws a confusion-matrix PNG and a ROC PNG into the config's ``img_dir``
with matplotlib, which the card does not have, the port writes the same
numbers as ``eval_<epoch>.json`` there: the confusion counts at ``Opt thr``
and the ROC curve's points.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .. import parallel
from ..device import float32_matmuls, resolve_device
from ..losses import SoftmaxBasedMetricLearning
from ..weights import init_random_
from .metrics import (confusion_counts, cosine_pair_scores, recall_at_k, roc_curve,
                      verification_metrics)
from .train_state import TrainState, finish_step


class Controller:
    """The FE task over a config; ``gradient_clip_val`` and
    ``accumulate_grad_batches`` are set by the ``Trainer`` before
    ``init_state``."""

    def __init__(self, config, gradient_clip_val: float | None = None,
                 accumulate_grad_batches: int = 1, mesh: parallel.Mesh | None = None):
        self.config = config
        self.gradient_clip_val = gradient_clip_val
        self.accumulate_grad_batches = accumulate_grad_batches
        self.mesh = mesh

    def build_model(self, device: str | torch.device = "cuda") -> SoftmaxBasedMetricLearning:
        """The config's wrapper over its embedder, built for ``device``."""
        return self.config.loss(self.config, self.config.model(device))

    def init_state(self, seed: int = 0, device: str | torch.device = "cuda",
                   model: SoftmaxBasedMetricLearning | None = None) -> TrainState:
        """The wrapper (seeded random weights unless ``model`` is given) in
        ``train()`` on ``device``, its optimiser, step 0."""
        dev = resolve_device(device)
        if model is None:
            model = init_random_(self.build_model(dev), seed)
        model = model.to(dev).train()
        parallel.broadcast_module(model, self.mesh)
        optimizer, schedule = self.config.optimizer(self.config)(model)
        return TrainState(model, optimizer, schedule, seed)

    @float32_matmuls()
    def train_step(self, state: TrainState, batch: dict) -> dict[str, float]:
        """One (mini-)step on ``{"x" (B, H, W, 3) float [0, 1], "label" (B,)}``;
        afterwards each parameter's ``.grad`` holds this step's gradient (or
        the accumulated mean that was stepped)."""
        model = state.model.train()
        dev = next(model.parameters()).device
        x = torch.as_tensor(np.asarray(batch["x"]), dtype=torch.float32).to(dev)
        labels = torch.as_tensor(np.asarray(batch["label"]), dtype=torch.int64).to(dev)
        state.optimizer.zero_grad(set_to_none=True)
        with parallel.data_parallel(self.mesh):
            out = model(x, labels)
            out["loss"].backward()
        acc = (out["logits"].argmax(-1) == labels).float().mean()
        metrics = {"loss": float(out["loss"].detach()), "train_acc": float(acc)}
        parallel.all_reduce_gradients(model.parameters(), self.mesh)
        finish_step(state, self.accumulate_grad_batches, self.gradient_clip_val)
        return parallel.all_reduce_mean(metrics, self.mesh, dev)

    def make_eval_step(self) -> Callable:
        """``eval_step(state, x) -> embeddings``: the wrapper in ``eval()``
        under ``torch.no_grad()`` (float32 embeddings from a trunk in its
        compute dtype), back in ``train()`` after."""

        @float32_matmuls()
        @torch.no_grad()
        def eval_step(state: TrainState, x: torch.Tensor) -> torch.Tensor:
            model = state.model.eval()
            try:
                return model(x)
            finally:
                model.train()

        return eval_step

    def run_eval_batch(self, eval_step: Callable, state: TrainState, batch: dict) -> dict:
        """The global batch's embeddings (this rank's rows embedded, the rows
        of every rank gathered in order under a mesh), labels and indices."""
        dev = next(state.model.parameters()).device
        x = parallel.shard_batch(np.asarray(batch["x"]), self.mesh)
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        emb = parallel.all_gather_rows(eval_step(state, x), self.mesh)
        return {"emb": emb.cpu().numpy(),
                "label": np.asarray(batch["label"]), "index": np.asarray(batch["index"])}

    def evaluate(self, outputs: list[list[dict]], logger=None, epoch: int = 0,
                 prefix: str = "") -> dict[str, dict[str, float]]:
        """``outputs[i]``: the ``run_eval_batch`` results of eval loader ``i``,
        scored over ``config.pair_generator(i)``; returns ``{name: metrics}``
        and logs them (or prints them without a logger)."""
        all_metrics, curves = {}, {}
        for i, batches in enumerate(outputs):
            emb = np.concatenate([np.asarray(b["emb"]) for b in batches], axis=0)
            classes = np.concatenate([np.asarray(b["label"]) for b in batches])
            indices = np.concatenate([np.asarray(b["index"]) for b in batches])
            order = np.argsort(indices)
            emb, classes = emb[order], classes[order]

            name, pair_generator = self.config.pair_generator(i)
            pairs = np.asarray(pair_generator.corrected_indices)
            labels = np.asarray(pair_generator.labels)
            similarity_f = self.config.get("similarity_f") or cosine_pair_scores
            scores = np.asarray(similarity_f(torch.from_numpy(emb), pairs))
            metrics = verification_metrics(
                scores, labels, thrs=tuple(self.config.get("thrs", ())),
                far_thrs=tuple(self.config.get("far_thr", ())),
                frr_thrs=tuple(self.config.get("frr_thr", ())))
            metrics.update(recall_at_k(emb, classes, tuple(self.config.get("k", ()))))
            all_metrics[name] = metrics
            curves[name] = eval_curves(scores, labels, metrics)
            if logger is not None:
                logger.log_metrics({f"{prefix}{name} {k}": v for k, v in metrics.items()},
                                   epoch)
            else:
                print(*[f"{name} {k}\t{v}" for k, v in metrics.items()], sep="\n")
        img_dir = self.config.get("img_dir")
        if img_dir is not None:
            img_dir = Path(img_dir)
            img_dir.mkdir(parents=True, exist_ok=True)
            (img_dir / f"eval_{epoch}.json").write_text(json.dumps(curves))
        return all_metrics

    def train_dataloader(self):
        return self.config.train_dataloader()

    def val_dataloader(self):
        return self.config.val_dataloader()

    def test_dataloader(self):
        dl = self.config.get("test_dataloader")
        return dl() if dl is not None else self.config.val_dataloader()


def eval_curves(scores: np.ndarray, labels: np.ndarray, metrics: dict) -> dict:
    """What the JAX ``_save_eval_plots`` draws, as numbers: the confusion
    counts of ``score > Opt thr`` and the ROC curve (``inf`` first)."""
    tp, fp, fn, tn = confusion_counts(scores, labels, metrics.get("Opt thr", 0.5))
    fpr, tpr, thr = roc_curve(labels, scores)
    return {"opt_thr": metrics.get("Opt thr", 0.5), "roc_auc": metrics["ROC AUC"],
            "confusion": {"tn": tn, "fp": fp, "fn": fn, "tp": tp},
            "roc": {"fpr": fpr.tolist(), "tpr": tpr.tolist(), "thresholds": thr.tolist()}}
