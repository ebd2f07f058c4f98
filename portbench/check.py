"""The numbers that decide `correct`, and their limits.

Training (drivers/train.py, reference/train.py): `loss<i>_rel`, the
relative gap of step i's loss; `grad_leaf`, the first gradient's norm,
and `step_leaf`, the change after the checked steps, each by the worst
leaf; `landmark_px`, the widest gap between the program's extracted
landmarks and the reference's over every training frame; `unmatched`,
the frames the program fed or extracted that the films do not hold.

A cell's limits (limits/<cell>.json) name the numbers that decide its
`correct`; the others are computed for the readings in PERF.md, which
gives the readings each limit was set from.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

Checks = List[Tuple[str, float, float]]  # (name, number, limit)


def load_limits(root: Path, cell: str) -> Dict[str, float]:
    path = root / "limits" / f"{cell}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Checks]:
    """Each number the limits name against its limit; a number that is
    missing or not finite fails, and so does a cell without limits."""
    checks = [(k, numbers.get(k, float("nan")), lim) for k, lim in limits.items()]
    ok = bool(checks) and all(np.isfinite(v) and v <= lim for _, v, lim in checks)
    return ok, checks


def report(checks: Checks) -> Dict[str, Dict[str, float]]:
    """Print each number beside its limit on standard error (the last lines
    it gets) and return them for the result's line."""
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return {name: {"value": value, "limit": limit} for name, value, limit in checks}
