"""Results processors: evaluation metrics, calibration, MI, clinical metrics,
figures and the HDF5 prediction writer.

Counterpart of contouring_uncertainty_tpu/results/__init__.py. Each
processor is a callable `(results: List[BatchResult], out_dir) -> dict`
(with `device` too where it computes on the device) registered under the
name the data configs list in `results_processors`; `run_processors` runs
the configured ones (by default all) and writes the same artifacts as the
JAX package (instant_metrics.csv, clinical/{instant,view,patient,volume}_df.csv,
lung_clinical/view_df.csv, the .npy dicts, the figures under their JAX file
names, predictions.h5, metrics.json), without pandas.

A processor that raises and a name nobody registered are each recorded in
the return value's and metrics.json's `processor_errors`, never skipped
silently.

matplotlib and h5py are imported only inside the functions that draw or
write: the machine with the card has neither. Where one is missing:

- `point_metrics`, `instant_metrics`, `clinical_metrics` (its calibration
  and correlation plots), `skewness` and `plotting` draw each figure where
  the JAX package does, but after their numbers, CSVs and .npy files are
  written (`draw_figures`). A `ModuleNotFoundError` whose `name` is
  "matplotlib", and only that, keeps the processor's numbers: it is
  recorded under a top-level `figure_errors` dict,
  {processor: "ModuleNotFoundError: No module named 'matplotlib'"}, apart
  from `processor_errors`, and written to metrics.json too. (The JAX
  package would lose those processors' numbers.)
- Any other exception in a figure fails its processor into
  `processor_errors`, as in the JAX package.
- `clinical_metrics`' per-view dashboards record their failure, whatever
  it is, under `clinical_metrics/metric_figures_error`, as in the JAX
  package.
- `prediction_writer` imports h5py first, as in the JAX package: without
  it the processor fails into `processor_errors` and writes nothing.
"""

from __future__ import annotations

import json
import traceback
from pathlib import Path
from typing import Dict

import numpy as np

from contouring_uncertainty_torch.device import DeviceLike, resolve_device

PROCESSORS: Dict = {}  # name -> (fn, whether fn takes the device)


def register(name, on_device: bool = False):
    def deco(fn):
        PROCESSORS[name] = (fn, on_device)
        return fn
    return deco


class FiguresMissing(Exception):
    """A processor's figures need matplotlib, which is not installed; its
    numbers (`metrics`) and files are written."""

    def __init__(self, metrics: Dict):
        super().__init__("No module named 'matplotlib'")
        self.metrics = metrics


def draw_figures(metrics: Dict, draws) -> Dict:
    """Call each of `draws` (a processor's figures, after its numbers and
    files are written) and return `metrics`. A missing matplotlib raises
    FiguresMissing(metrics); any other exception propagates."""
    try:
        for draw in draws:
            draw()
    except ModuleNotFoundError as exc:
        if exc.name != "matplotlib":
            raise
        raise FiguresMissing(metrics) from exc
    return metrics


def run_processors(results, out_dir: Path, cfg: Dict, device: DeviceLike = None) -> Dict:
    """Run the processors `cfg["data"]["results_processors"]` names (by
    default every registered processor) into `out_dir`.
    `device` (default cuda) is where the clinical metrics reduce the sample
    populations."""
    from contouring_uncertainty_torch.results import (  # noqa: F401 (registration)
        calibration,
        clinical,
        extras,
        instant_metrics,
        lung_clinical,
        mutual_information,
        point_metrics,
    )

    device = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    names = cfg.get("data", {}).get("results_processors", [*PROCESSORS])
    all_metrics: Dict = {}
    failures: Dict[str, str] = {}
    figure_failures: Dict[str, str] = {}
    for name in names:
        if name not in PROCESSORS:
            failures[name] = "unknown processor (not registered)"
            print(f"[results] processor {name} is not registered")
            continue
        fn, on_device = PROCESSORS[name]
        try:
            metrics = fn(results, out_dir, device) if on_device else fn(results, out_dir)
        except FiguresMissing as exc:
            metrics = exc.metrics
            figure_failures[name] = f"ModuleNotFoundError: {exc}"
            print(f"[results] processor {name}: figures not drawn ({figure_failures[name]})")
        except Exception as exc:
            # A failing processor must not stop the others; its failure is
            # recorded (metrics.json and the return value).
            failures[name] = f"{type(exc).__name__}: {exc}"
            traceback.print_exc()
            print(f"[results] processor {name} failed: {failures[name]}")
            continue
        all_metrics.update({f"{name}/{k}": v for k, v in (metrics or {}).items()})
    if failures:
        all_metrics["processor_errors"] = failures
    if figure_failures:
        all_metrics["figure_errors"] = figure_failures
    if all_metrics:
        (out_dir / "metrics.json").write_text(
            json.dumps({k: _to_py(v) for k, v in all_metrics.items()}, indent=2))
    return all_metrics


def _to_py(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v
