"""Arithmetic the per-layer metric readers share."""

from __future__ import annotations

from portbench import work


def mfu(reading):
    """The backbone's FLOPs of the traced steps over the traced window, as
    a share of the f32 peak, in %."""
    if reading is None or reading.window_s <= 0 or reading.flops <= 0:
        return None
    return 100.0 * reading.flops / reading.window_s / work.F32_FLOPS_PER_S


def idle(reading):
    """1 - the device's busy time (the union of its kernels, copies and
    memsets) over the traced window, in %."""
    if reading is None or reading.window_s <= 0 or not reading.device:
        return None
    return 100.0 * (1.0 - reading.busy_s() / reading.window_s)


def roofline(reading, kernel: str, needle: str, exclude: str = ""):
    """The least time of the launches' work (work.bound_seconds) over the
    traced time of the kernel's launches, in %. Nothing where the trace
    holds another number of launches than the plan of the traced work."""
    if reading is None:
        return None
    plan = reading.launches.get(kernel, [])
    times = reading.kernels(needle, exclude)
    if not plan or len(times) != len(plan) or sum(times) <= 0:
        return None
    return 100.0 * sum(work.bound_seconds(w) for w in plan) / sum(times)
