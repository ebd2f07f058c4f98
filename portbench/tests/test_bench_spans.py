"""The readers of the program's `cut.` spans (metrics/_spans.py and the
ten metrics on it).

On the CPU, a hand-built traced epoch: the device's idle gaps cut at the
spans' boundaries and charged to the innermost span, the five `idle_*`
shares and the two remainders summing to `idle.train`, the runtime calls
counted inside train steps only, the device's busy time inside the
forward's device extents, and no reading without a step span; the trace's
device extents of annotated ranges kept out of the device's work.

On the card, a traced run of the training cell, with the profiler's raw
trace kept: one `cut.train.step` a traced step, and every K2 launch
(`dsnt_moments_kernel`, the row layout) made from inside a
`cut.train.forward` and started on the device after that span opened;
`forward_busy_ms.train` read, within the traced busy time a step.
"""

import json
import shutil
from argparse import Namespace
from pathlib import Path

import pytest

from portbench import devtrace, harness
from portbench.metrics import _shared, _spans

REPO = Path(__file__).resolve().parents[2]
MANIFEST = harness.Manifest(REPO / "BENCHMARK.json")
IDLE = ["idle_feed.train", "idle_augment.train", "idle_forward.train", "idle_backward.train",
        "idle_update.train"]


def _epoch(steps=True):
    """A traced window of 12 s. Device busy [0, 1], [3, 4], [6, 8], [11.5, 11.8]:
    idle (1, 3), (4, 6), (8, 11.5), (11.8, 12), 7.7 s. One step [0.5, 9]
    with its parts, a starved feed wait [0.1, 0.4] and a queued one
    [9.5, 11]; the harness's own spans and host ops around them."""
    host = [("portbench.traced", 0.0, 12.0), ("portbench.feed_wait", 0.05, 0.45),
            ("cut.feed.starved", 0.1, 0.4), ("portbench.train_step", 0.45, 9.1),
            ("cut.train.augment", 0.5, 2.0), ("cut.train.zero_grad", 2.0, 2.5),
            ("cut.train.forward", 2.5, 5.0), ("cut.train.backward", 5.0, 7.0),
            ("cut.train.update", 7.0, 8.5), ("portbench.feed_wait", 9.4, 11.2),
            ("cut.feed.get", 9.5, 11.0), ("aten::conv2d", 2.6, 4.5),
            ("cudaLaunchKernel", 0.6, 0.61), ("cuLaunchKernel", 5.5, 5.51),
            ("cudaLaunchKernel", 11.4, 11.41), ("cudaStreamSynchronize", 3.0, 3.9),
            ("cudaMemcpy", 6.0, 6.1), ("cudaMemcpyAsync", 4.0, 4.1),
            ("cudaDeviceSynchronize", 9.2, 9.3)]
    if steps:
        host.append(("cut.train.step", 0.5, 9.0))
    device = [("k", 0.0, 1.0), ("k", 3.0, 4.0), ("k", 6.0, 8.0), ("k", 11.5, 11.8)]
    return devtrace.Reading(window_s=12.0, device=device, host=host, kind="train")


def _read(name, reading):
    return MANIFEST.metric_reader(name).read(reading, None)


def test_gaps_are_cut_at_span_boundaries():
    """The gap (1, 3) crosses augment, zero_grad and forward and is cut at
    2 and 2.5; (8, 11.5) runs from the update through the step's own end,
    outside every span, into the feed's wait and out again."""
    charged = _spans.idle_by_span(_epoch())
    expected = {"cut.train.augment": 1.0, "cut.train.zero_grad": 0.5, "cut.train.forward": 1.5,
                "cut.train.backward": 1.0, "cut.train.update": 0.5, "cut.train.step": 0.5,
                "cut.feed.get": 1.5, "": 1.2}
    assert charged.keys() == expected.keys()
    for key, value in expected.items():
        assert charged[key] == pytest.approx(value, abs=1e-12), key


def test_shares_and_remainders_partition_idle():
    """The five `idle_*` shares plus the step's own remainder and the
    remainder outside every span equal `idle.train` to 1e-9."""
    reading = _epoch()
    shares = {name: _read(name, reading) for name in IDLE}
    charged = _spans.idle_by_span(reading)
    rest = 100.0 * (charged[_spans.STEP] + charged[_spans.OUTSIDE]) / reading.window_s
    assert abs(sum(shares.values()) + rest - _shared.idle(reading)) < 1e-9
    assert shares["idle_update.train"] == pytest.approx(100.0 * 1.0 / 12.0)
    assert shares["idle_feed.train"] == pytest.approx(100.0 * 1.5 / 12.0)


def test_runtime_calls_count_inside_steps_only():
    """Syncs and launches count where they start inside `cut.train.step`:
    the blocking `cudaMemcpy` does, `cudaMemcpyAsync` does not, and the
    sync and launch after the step do not; per step, over two steps."""
    reading = _epoch()
    assert _read("host_syncs.train", reading) == 2.0
    assert _read("launches.train", reading) == 2.0
    reading.host.append(("cut.train.step", 11.2, 11.9))
    assert _read("host_syncs.train", reading) == 1.0
    assert _read("launches.train", reading) == 1.5


def test_feed_readers():
    reading = _epoch()
    assert _read("feed_get_ms.train", reading) == pytest.approx(1e3 * (0.3 + 1.5) / 2)
    assert _read("feed_starved.train", reading) == 50.0


@pytest.mark.parametrize("name", IDLE + ["feed_get_ms.train", "feed_starved.train",
                                         "host_syncs.train", "launches.train",
                                         "forward_busy_ms.train"])
def test_no_step_span_reads_nothing(name):
    """A program without the spans (the harness's own spans alone), or no
    trace at all: every reader returns None."""
    assert _read(name, _epoch(steps=False)) is None
    assert _read(name, None) is None


def test_annotations_stay_apart_from_device_work():
    """`gpu_user_annotation` events (a host range's device extent) go to
    `Reading.annotations`, never to `device`: busy time, gaps and breakdown
    read what they read without them."""
    def event(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    work = [event("user_annotation", "portbench.traced", 1000.0, 12e6),
            event("user_annotation", "cut.train.forward", 1000.0 + 2.5e6, 2.5e6),
            event("kernel", "k", 1000.0, 1e6), event("gpu_memcpy", "copy", 1000.0 + 3e6, 1e6),
            event("kernel", "k", 1000.0 + 6e6, 2e6), {"ph": "i", "name": "marker", "ts": 0.0}]
    extents = [event("gpu_user_annotation", "cut.train.forward", 1000.0 + 2.9e6, 3.5e6),
               event("gpu_user_annotation", "portbench.traced", 1000.0, 8e6)]
    plain, kept = (devtrace.Reading(window_s=12.0, kind="train") for _ in range(2))
    devtrace.add_events(plain, work)
    devtrace.add_events(kept, work + extents)
    assert kept.device == plain.device and kept.host == plain.host
    assert plain.annotations == []
    assert kept.annotations == [("cut.train.forward", pytest.approx(2.9), pytest.approx(6.4)),
                                ("portbench.traced", 0.0, 8.0)]
    assert kept.busy_s() == plain.busy_s() == pytest.approx(4.0)
    assert kept.gaps() == plain.gaps()
    assert kept.breakdown() == plain.breakdown()


def test_forward_busy_is_the_union_inside_the_forward_extents():
    """Two steps. The forward's extents [2.5, 5] and [9.5, 10]; kernels
    that overlap each other and the extents' edges: inside the first,
    [2.5, 3.5] and [4, 5], 2 s; inside the second, [9.6, 9.8], 0.2 s. The
    backward's extent and the kernels outside count nothing: 1.1 s a step."""
    reading = _epoch()
    reading.host.append(("cut.train.step", 9.2, 11.0))
    reading.device = [("k", 2.0, 3.0), ("k", 2.8, 3.5), ("k", 4.0, 4.5), ("k", 4.2, 6.0),
                      ("k", 9.6, 9.7), ("k", 9.65, 9.8), ("k", 10.5, 10.9), ("k", 0.0, 1.0)]
    reading.annotations = [("cut.train.forward", 2.5, 5.0), ("cut.train.backward", 5.0, 7.0),
                           ("cut.train.forward", 9.5, 10.0)]
    assert _read("forward_busy_ms.train", reading) == pytest.approx(1e3 * 2.2 / 2)
    reading.annotations = reading.annotations[1:2]
    assert _read("forward_busy_ms.train", reading) is None


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """A traced run of the training cell on the card, the profiler's raw
    trace copied as it is exported: its result line and the trace's
    complete events."""
    import torch
    import torch.profiler

    from portbench import run

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the kernels on the card")
    kept = tmp_path_factory.mktemp("trace") / "raw.json"

    class Keeping(torch.profiler.profile):
        def export_chrome_trace(self, path):
            super().export_chrome_trace(path)
            shutil.copy(path, kept)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(torch.profiler, "profile", Keeping)
        args = Namespace(workload="camus-dsnt-al.train", seed=2 ** 31 + 7, seconds=1.0, trace=1)
        result = run.measure(args, MANIFEST)
    events = [e for e in json.loads(kept.read_text())["traceEvents"] if e.get("ph") == "X"]
    return result, events


@pytest.mark.card
def test_k2_launches_inside_forward_on_one_clock(card, traced_run):
    """One `cut.train.step` per traced step, one K2 launch a step, each
    launch call inside a `cut.train.forward` and its kernel started on the
    device after that span's start."""
    result, events = traced_run
    assert result["correct"]
    assert {"feed_get_ms.train", "host_syncs.train", "idle_forward.train"} <= set(
        result["metrics"])

    # The host's spans (the device's copies of them, `gpu_user_annotation`, left out).
    host = [e for e in events if e.get("cat") == "user_annotation"]
    steps = [e for e in host if e["name"] == "cut.train.step"]
    traced = sum(e["name"] == "portbench.train_step" for e in host)
    assert traced > 0 and len(steps) == traced
    forwards = [(e["ts"], e["ts"] + e["dur"]) for e in host if e["name"] == "cut.train.forward"]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    k2 = [e for e in events if e.get("cat") == "kernel" and "dsnt_moments_kernel" in e["name"]
          and "cols" not in e["name"]]
    assert len(k2) == len(steps)
    for kernel in k2:
        call = calls[kernel["args"]["correlation"]]
        span = [(a, b) for a, b in forwards if a <= call["ts"] <= b]
        assert len(span) == 1, call
        assert kernel["ts"] >= span[0][0]


@pytest.mark.card
def test_forward_busy_is_read_on_the_card(card, traced_run):
    """The forward's device extents are in the trace, and
    `forward_busy_ms.train` reads a positive number no larger than the
    traced busy time over the traced steps."""
    result, events = traced_run
    steps = sum(e.get("cat") == "user_annotation" and e["name"] == "cut.train.step"
                for e in events)
    assert any(e.get("cat") == "gpu_user_annotation" and e["name"] == "cut.train.forward"
               for e in events)
    busy_ms = result["metrics"]["forward_busy_ms.train"]["value"]
    assert 0.0 < busy_ms <= 1e3 * result["device"]["busy_s"] / steps
