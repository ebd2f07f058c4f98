"""The program's own spans in the traced epoch (`cut.` names, opened by
`contouring_uncertainty_torch/utils/profiling.py span` while the profiler
records), the runtime calls inside its train steps, the device's idle
time charged to the spans, and its busy time inside a span's device
extent.

Everything is read from `Reading.host`, `Reading.device` and
`Reading.annotations` (the spans' device extents), on the trace's one
clock. A traced epoch with no `cut.train.step` (a program without the
spans) gives None.
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


def _merged(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_under(reading, name: str) -> Optional[float]:
    """The device's busy seconds (the union of its kernels, copies and
    memsets) inside the device extents of the `name` span, per train step;
    None where the trace holds no such extent."""
    inside = steps(reading)
    extents = [(s, e) for n, s, e in reading.annotations if n == name] if inside else []
    if not extents:
        return None
    busy = _merged((s, e) for _, s, e in reading.device)
    total, i = 0.0, 0
    for a, b in _merged(extents):
        while i < len(busy) and busy[i][1] <= a:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < b:
            total += min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
    return total / len(inside)
