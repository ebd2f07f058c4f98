"""The traced part of a window: torch.profiler over whole steps, reduced to device intervals, the harness's spans and the numbers
the per-layer metrics read.

Device intervals are the profiler's CUDA-side events (kernels, copies,
memsets). The busy time is the length of their union; the traced window
is the host's time from the profiler's start to a synchronise after the
traced work. Idle gaps are named by the harness span open at the gap's
middle and the innermost host operation running there. The device
extents of the host's annotated ranges (`cut.` spans and the harness's
own; trace category `gpu_user_annotation`) are kept apart, in
`Reading.annotations`: they are no device work, and add nothing to the
busy time, the gaps or the breakdown.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

SPAN_PREFIX = "portbench."
# Trace event categories: the device's work, and what the host was doing.
DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
ANNOTATION = "gpu_user_annotation"  # a host range's extent on the device


@dataclass
class Reading:
    """What the traced part left for the per-layer metrics to read."""

    window_s: float = 0.0
    device: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, start, end) s
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    # The device extents of annotated host ranges (name, start, end) s: from
    # the first device operation launched inside the range to the last one's end.
    annotations: List[Tuple[str, float, float]] = field(default_factory=list)
    flops: float = 0.0  # the backbone's FLOPs of the traced steps (its `train_flops`)
    launches: Dict[str, List[Dict[str, float]]] = field(default_factory=dict)  # kernel -> work
    kind: str = ""  # the driver that traced it: "train"
    t0: float = 0.0  # the traced window's start on the events' clock (s)

    def kernels(self, needle: str, exclude: str = "") -> List[float]:
        """Durations (s) of the device kernels whose name holds `needle`."""
        return [e - s for n, s, e in self.device
                if needle in n and not (exclude and exclude in n)]

    def busy_s(self) -> float:
        total, end = 0.0, float("-inf")
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if e > end:
                total += e - max(s, end)
                end = e
        return total

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals of the device inside the traced window."""
        out, end = [], self.t0
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if self.t0 + self.window_s > end:
            out.append((end, self.t0 + self.window_s))
        return out

    def breakdown(self, n: int = 10, named: int = 200) -> Dict[str, list]:
        """The `n` device operations that took most time, and the idle time
        of the `named` longest gaps summed by what the host was doing in
        each (the `n` largest sums)."""
        by_name: Dict[str, float] = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:named]
        starts = np.array([s for _, s, _ in self.host])
        ends = np.array([e for _, _, e in self.host])
        sums: Dict[str, float] = {}
        for s, e in gaps:
            key = self._host_at(0.5 * (s + e), starts, ends)
            sums[key] = sums.get(key, 0.0) + (e - s)
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in top]}

    def _host_at(self, t: float, starts: np.ndarray, ends: np.ndarray) -> str:
        """The harness span open at host time t and the innermost host
        operation running there."""
        span, inner, inner_len = "outside spans", "no host op", float("inf")
        for i in np.flatnonzero((starts <= t) & (t <= ends)):
            name, s, e = self.host[i]
            if name.startswith(SPAN_PREFIX):
                span = name[len(SPAN_PREFIX):]
            elif e - s < inner_len:
                inner, inner_len = name, e - s
        return f"{span} / {inner}"


@contextlib.contextmanager
def traced(reading: Optional[Reading]):
    """Profile the block into `reading` (None: run it untraced)."""
    if reading is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    sync()
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + "traced"):
            yield
        sync()
        reading.window_s = time.perf_counter() - start
    # The profiler's own trace file, read back: building its FunctionEvent
    # tree in Python would take minutes for the launches of an epoch.
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    add_events(reading, events)


def add_events(reading: Reading, events: List[dict]) -> None:
    """The trace's complete events into `reading`, in seconds from the
    start of the harness's `traced` span: device work, host ranges and
    device extents of annotated ranges each in a list of its own."""
    spans = [e for e in events if e.get("name") == SPAN_PREFIX + "traced"
             and e.get("cat") == "user_annotation"]
    first = spans[0]["ts"] if spans else 0.0
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in DEVICE | HOST | {ANNOTATION}:
            continue
        item = (e["name"], (e["ts"] - first) * 1e-6, (e["ts"] + e.get("dur", 0) - first) * 1e-6)
        (reading.device if cat in DEVICE else reading.annotations if cat == ANNOTATION
         else reading.host).append(item)


@contextlib.contextmanager
def span(name: str):
    """A harness span around a call into one of the program's layers: a
    `record_function` the profiler sees, which names the idle gaps under
    it."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield
