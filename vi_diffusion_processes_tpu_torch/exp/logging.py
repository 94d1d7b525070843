"""Experiment observability: JSONL metric streams with an optional wandb sink
(vi_diffusion_processes_tpu/exp/logging.py).

The reference logs per-step elbo/nlpd/rmse and learned prior-parameter
curves to **wandb** (exp_dp_utils.py:282-291, cvi_dp_trainer.py:79-82) and
matplotlib images to the Hydra run dir.  Here the primary sink is an
append-only JSONL file — trivially consumed by pandas / jq / dashboards and
dependency-free — with wandb attached transparently when the package is
installed and a run is requested.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, Optional, Union

__all__ = ["MetricsLogger"]


class MetricsLogger:
    """Append-only JSONL metrics stream.

    Each ``log(step, **metrics)`` call writes one line
    ``{"step": ..., "wall_time": ..., <metrics>}``.  ``wandb=`` mirrors the
    reference's optional project logging: pass a project name and the
    logger forwards every record if wandb is importable, and silently
    degrades to JSONL-only otherwise.
    """

    def __init__(
        self,
        path: Union[str, pathlib.Path, None] = None,
        wandb: Optional[str] = None,
        config: Optional[Dict] = None,
    ):
        self._path = pathlib.Path(path) if path is not None else None
        if self._path is not None:
            self._path.parent.mkdir(parents=True, exist_ok=True)
        self._t0 = time.perf_counter()
        self._wandb_run = None
        if wandb is not None:
            try:  # pragma: no cover - wandb not installed in CI
                import wandb as _wandb

                self._wandb_run = _wandb.init(project=wandb, config=config or {})
            except Exception:
                self._wandb_run = None

    def log(self, step: int, **metrics) -> None:
        record = {"step": int(step), "wall_time": time.perf_counter() - self._t0}
        record.update({k: float(v) for k, v in metrics.items()})
        if self._path is not None:
            with self._path.open("a") as f:
                f.write(json.dumps(record) + "\n")
        if self._wandb_run is not None:  # pragma: no cover
            self._wandb_run.log(metrics, step=step)

    def read(self):
        """Return all logged records (for tests / notebooks)."""
        if self._path is None or not self._path.exists():
            return []
        return [json.loads(line) for line in self._path.read_text().splitlines()]

    def close(self) -> None:
        if self._wandb_run is not None:  # pragma: no cover
            self._wandb_run.finish()
