"""Experiment logger: one JSONL record per logged step, fanned out to Comet
and TensorBoard when asked.

Counterpart of contouring_uncertainty_tpu/train/logging.py. The JSONL file
is always written; `use_comet` starts a `comet_ml.Experiment` in the
project PROJECT_NAME and `use_tensorboard` a
`torch.utils.tensorboard.SummaryWriter` under `<run_dir>/tb`. A back end
that fails to start (not installed, no API key) prints why and the run goes
on with JSONL, as in the JAX package. Both are imported only when asked
for. The metrics CSV is written by the trainer itself. `log_figure`
writes a matplotlib figure under `<run_dir>/figures/` and hands it to the
back ends that started.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

PROJECT_NAME = "contouring-uncertainty-tpu"


class ExperimentLogger:
    """Fan-out logger: the JSONL file, and the Comet and TensorBoard back
    ends that started."""

    def __init__(self, run_dir: str | Path, name: str,
                 use_comet: bool = False, use_tensorboard: bool = False):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.run_dir / f"{name}_metrics.jsonl", "a")
        self._comet = None
        self._tb = None
        if use_comet:
            try:
                import comet_ml

                self._comet = comet_ml.Experiment(project_name=PROJECT_NAME)
            except Exception as exc:
                print(f"[logger] comet unavailable ({exc}); falling back to JSONL")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(self.run_dir / "tb"))
            except Exception as exc:
                print(f"[logger] tensorboard unavailable ({exc}); falling back to JSONL")

    def log_metrics(self, metrics: Dict, step: Optional[int] = None):
        record = {"step": step, **{k: _py(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._comet is not None:
            self._comet.log_metrics(metrics, step=step)
        if self._tb is not None:
            for key, value in metrics.items():
                try:
                    self._tb.add_scalar(key, float(value), step or 0)
                except (TypeError, ValueError):
                    pass

    def log_figure(self, name: str, fig, step: Optional[int] = None):
        """Save a matplotlib figure as figures/{name}_{step}.png (dpi 80)
        and attach it to Comet and TensorBoard where they started (a
        TensorBoard failure is ignored, as in the JAX package)."""
        path = self.run_dir / "figures" / f"{name}_{step or 0}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(path, dpi=80)
        if self._comet is not None:
            self._comet.log_figure(name, fig, step=step)
        if self._tb is not None:
            try:
                self._tb.add_figure(name, fig, step or 0)
            except Exception:
                pass

    def close(self):
        self._jsonl.close()
        if self._comet is not None:
            self._comet.end()
        if self._tb is not None:
            self._tb.close()


def _py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
