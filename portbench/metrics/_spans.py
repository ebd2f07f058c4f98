"""The program's own spans in the traced epoch (`cut.` names, opened by
`contouring_uncertainty_torch/utils/profiling.py span` while the profiler
records), the runtime calls inside its train steps, and the device's idle
time charged to the spans.

Everything is read from `Reading.host` and `Reading.device`, on the
trace's one clock. A traced epoch with no `cut.train.step` (a program
without the spans) gives None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

PREFIX = "cut."
STEP = "cut.train.step"
FEED = ("cut.feed.get", "cut.feed.starved")
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy"}
LAUNCHES = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"}
OUTSIDE = ""  # idle_by_span's key for idle time under no `cut.` span


def spans(reading, names=None) -> List[Tuple[str, float, float]]:
    """The `cut.` spans (name, start, end) of the traced epoch, or those of `names`."""
    return [(n, s, e) for n, s, e in reading.host
            if n.startswith(PREFIX) and (names is None or n in names)]


def steps(reading) -> Optional[List[Tuple[str, float, float]]]:
    """The traced epoch's train steps; None where it holds none."""
    if reading is None or reading.kind != "train":
        return None
    return spans(reading, (STEP,)) or None


def calls_per_step(reading, names) -> Optional[float]:
    """Host events named in `names` that start inside a train step, per step."""
    inside = steps(reading)
    if inside is None:
        return None
    starts = np.array([s for n, s, _ in reading.host if n in names])
    return sum(int(((a <= starts) & (starts <= b)).sum()) for _, a, b in inside) / len(inside)


def idle_by_span(reading) -> Dict[str, float]:
    """The device's idle seconds in the traced window (`Reading.gaps`), cut
    at every `cut.` span's start and end, each piece charged to the
    innermost `cut.` span open over it (OUTSIDE where none is)."""
    mine = spans(reading)
    gaps = reading.gaps()
    if not mine or not gaps:
        return {OUTSIDE: sum(b - a for a, b in gaps)} if gaps else {}
    starts = np.array([s for _, s, _ in mine])
    ends = np.array([e for _, _, e in mine])
    bounds = np.unique(np.concatenate([starts, ends]))
    points = [np.concatenate([[a], bounds[(bounds > a) & (bounds < b)], [b]]) for a, b in gaps]
    lo = np.concatenate([p[:-1] for p in points])
    hi = np.concatenate([p[1:] for p in points])
    mid = 0.5 * (lo + hi)
    open_ = (starts[None, :] <= mid[:, None]) & (mid[:, None] <= ends[None, :])
    # The spans are one thread's, so they nest: the innermost open is the shortest.
    inner = np.where(open_, ends - starts, np.inf).argmin(axis=1)
    charged: Dict[str, float] = {}
    for i, length in enumerate(hi - lo):
        key = mine[inner[i]][0] if open_[i, inner[i]] else OUTSIDE
        charged[key] = charged.get(key, 0.0) + float(length)
    return charged


def idle_share(reading, names) -> Optional[float]:
    """The idle time charged to the spans `names`, in % of the traced window."""
    if steps(reading) is None or reading.window_s <= 0:
        return None
    charged = idle_by_span(reading)
    return 100.0 * sum(charged.get(n, 0.0) for n in names) / reading.window_s
