"""Metric and artifact logging (counterpart of the JAX ``engine/logging.py``):
a run directory with ``metrics.jsonl`` (one JSON object per
``log_metrics`` call, stamped with the step and the time), ``params.json``
(the hyper-parameters' reprs) and every record mirrored to stdout. MLflow is
used only when asked for (``use_mlflow``, set by a config's
``mlflow_target_uri``), and imported only then."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping


class MetricsLogger:
    """File and stdout metric logger with an MLflow-compatible surface."""

    def __init__(self, output_dir: str | Path, run_name: str = "run",
                 experiment_name: str = "default", use_mlflow: bool = False):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.run_name = run_name
        self._metrics_file = self.output_dir / "metrics.jsonl"
        self._mlflow = None
        if use_mlflow:
            import mlflow

            mlflow.set_experiment(experiment_name)
            mlflow.start_run(run_name=run_name)
            self._mlflow = mlflow

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        safe = {k: repr(v) for k, v in params.items()}
        (self.output_dir / "params.json").write_text(json.dumps(safe, indent=2))
        if self._mlflow:
            self._mlflow.log_params({k: v[:250] for k, v in safe.items()})

    def log_metrics(self, metrics: Mapping[str, float], step: int = 0) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        with self._metrics_file.open("a") as f:
            f.write(json.dumps(record) + "\n")
        pretty = "  ".join(f"{k}={float(v):.6g}" for k, v in metrics.items())
        print(f"[step {step}] {pretty}", flush=True)
        if self._mlflow:
            self._mlflow.log_metrics({k: float(v) for k, v in metrics.items()}, step=step)

    def finalize(self, status: str = "FINISHED") -> None:
        if self._mlflow:
            self._mlflow.end_run(status=status)
