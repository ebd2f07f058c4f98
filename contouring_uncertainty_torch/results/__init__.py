"""Results processors: evaluation metrics, calibration, MI, clinical metrics.

Counterpart of contouring_uncertainty_tpu/results/__init__.py. Each
processor is a callable `(results: List[BatchResult], out_dir) -> dict`
(with `device` too where it computes on the device) registered under the
name the data configs list in `results_processors`; `run_processors` runs
the configured ones and writes the same artifacts as the JAX package
(instant_metrics.csv, clinical/{instant,view,patient,volume}_df.csv,
lung_clinical/view_df.csv, the .npy dicts, metrics.json), without pandas
and without figures.

A processor that raises, a name nobody registered, and a name the JAX
package registers but the port does not have yet are each recorded in the
return value's and metrics.json's `processor_errors`, never skipped
silently.
"""

from __future__ import annotations

import json
import traceback
from pathlib import Path
from typing import Dict

import numpy as np

from contouring_uncertainty_torch.device import DeviceLike, resolve_device

PROCESSORS: Dict = {}  # name -> (fn, whether fn takes the device)

# Processors of the JAX package the port does not have yet, with the
# ROADMAP.md Queue 1 item each waits for.
NOT_PORTED = {"plotting": 13, "prediction_writer": 13}
# Ported processors whose JAX counterpart also draws a figure the port does
# not draw yet, with that item.
FIGURES_NOT_PORTED = {"skewness": 13}


def register(name, on_device: bool = False):
    def deco(fn):
        PROCESSORS[name] = (fn, on_device)
        return fn
    return deco


def run_processors(results, out_dir: Path, cfg: Dict, device: DeviceLike = None) -> Dict:
    """Run the processors `cfg["data"]["results_processors"]` names (by
    default every processor the JAX package registers) into `out_dir`.
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
    names = cfg.get("data", {}).get("results_processors", [*PROCESSORS, *NOT_PORTED])
    all_metrics: Dict = {}
    failures: Dict[str, str] = {}
    for name in names:
        if name not in PROCESSORS:
            failures[name] = (f"not ported (ROADMAP.md Queue 1, item {NOT_PORTED[name]})"
                              if name in NOT_PORTED else "unknown processor (not registered)")
            print(f"[results] processor {name}: {failures[name]}")
            continue
        fn, on_device = PROCESSORS[name]
        try:
            metrics = fn(results, out_dir, device) if on_device else fn(results, out_dir)
        except Exception as exc:
            # A failing processor must not stop the others; its failure is
            # recorded (metrics.json and the return value).
            failures[name] = f"{type(exc).__name__}: {exc}"
            traceback.print_exc()
            print(f"[results] processor {name} failed: {failures[name]}")
            continue
        all_metrics.update({f"{name}/{k}": v for k, v in (metrics or {}).items()})
        if name in FIGURES_NOT_PORTED:
            print(f"[results] processor {name}: its figure is not ported "
                  f"(ROADMAP.md Queue 1, item {FIGURES_NOT_PORTED[name]})")
    if failures:
        all_metrics["processor_errors"] = failures
    if all_metrics:
        (out_dir / "metrics.json").write_text(
            json.dumps({k: _to_py(v) for k, v in all_metrics.items()}, indent=2))
    return all_metrics


def _to_py(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v
