"""Experiment logger: one JSONL record per logged step.

Counterpart of contouring_uncertainty_tpu/train/logging.py, JSONL part. The
Comet and TensorBoard back ends and figure logging are not ported
(ROADMAP.md Queue 1, items 5 and 13): asking for a back end raises rather
than dropping the request. The metrics CSV is written by the trainer itself.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional


class ExperimentLogger:
    def __init__(self, run_dir: str | Path, name: str,
                 use_comet: bool = False, use_tensorboard: bool = False):
        if use_comet or use_tensorboard:
            raise NotImplementedError(
                "Comet and TensorBoard logging are not ported yet (ROADMAP.md Queue 1, "
                "item 5); metrics go to the CSV and JSONL files")
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.run_dir / f"{name}_metrics.jsonl", "a")

    def log_metrics(self, metrics: Dict, step: Optional[int] = None):
        record = {"step": step, **{k: _py(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()


def _py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
