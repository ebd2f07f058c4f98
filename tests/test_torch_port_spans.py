"""The training path's `cut.` spans (utils/profiling.py `span`) on the CPU.

- With no profiler running, `span` hands back one shared null context and
  a train step and the device feed open no `record_function`;
- under `torch.profiler`, each step leaves one `cut.train.step` in the
  exported trace with its augment, zero_grad, forward, backward and update
  spans inside it, in that order, and the feed one `cut.feed.get` or
  `cut.feed.starved` per item it takes from its queue;
- a step under the profiler computes the same bits as one without.
"""

import json
import time

import numpy as np
import torch

from contouring_uncertainty_torch.data.config import DataParams
from contouring_uncertainty_torch.tasks import DSNTAleatoric
from contouring_uncertainty_torch.train import Trainer, TrainerConfig
from contouring_uncertainty_torch.train.trainer import _device_prefetch
from contouring_uncertainty_torch.utils import profiling

torch.set_num_threads(1)

SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3, drop_block=True)
CHILDREN = ["cut.train.augment", "cut.train.zero_grad", "cut.train.forward",
            "cut.train.backward", "cut.train.update"]


def _trainer():
    task = DSNTAleatoric(data_params=DataParams(in_shape=(1, 64, 64), out_shape=(21, 2)),
                         model_kwargs=SMALL)
    trainer = Trainer(task, TrainerConfig(batch_size=4, seed=3), device="cpu")
    trainer.init_state()
    return trainer


def _batches(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [{"img": torch.from_numpy(rng.integers(0, 256, (4, 1, 64, 64), dtype=np.uint8)),
             "contour": torch.from_numpy(rng.uniform(8, 56, (4, 21, 2)).astype(np.float32))}
            for _ in range(n)]


def _steps(trainer, batches):
    return [float(trainer.train_step(b, i)["loss"]) for i, b in enumerate(batches)]


def _cut_spans(prof, tmp_path):
    """The `cut.` spans of a finished profile: (name, start, end, tid), by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith("cut.")),
                  key=lambda s: s[1])


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def test_no_profiler_opens_no_record_function(monkeypatch):
    """Without a profiler `span` is the shared null context, and neither a
    train step nor the device feed reaches `record_function` with a `cut.`
    name (patched to raise; torch's optimizer opens its own names)."""
    assert profiling.span("cut.train.step") is profiling.span("cut.feed.get") is profiling._NULL
    trainer = _trainer()
    original = torch.autograd.profiler.record_function

    def refuse(name, *args, **kwargs):
        assert not name.startswith("cut."), f"record_function({name!r}) with no profiler running"
        return original(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    batches = list(_device_prefetch(iter(_batches()), torch.device("cpu")))
    assert np.isfinite(_steps(trainer, batches)).all()


def test_step_spans_nest_in_order(tmp_path):
    """One `cut.train.step` a step in the exported trace, its five parts
    inside it in the order the step runs them, all on the calling thread."""
    trainer = _trainer()
    with _profile() as prof:
        _steps(trainer, _batches())
    spans = _cut_spans(prof, tmp_path)
    steps = [s for s in spans if s[0] == "cut.train.step"]
    assert len(steps) == 2
    assert len({s[3] for s in spans}) == 1
    for _, start, end, _ in steps:
        inside = [s for s in spans if start <= s[1] and s[2] <= end and s[0] != "cut.train.step"]
        assert [s[0] for s in inside] == CHILDREN
        assert all(a[2] <= b[1] for a, b in zip(inside, inside[1:]))


def test_feed_spans_one_per_item(tmp_path):
    """The device feed leaves one `cut.feed.get` or `cut.feed.starved` per
    item it takes: each batch and the epoch's end. The first wait finds the
    queue empty (the source sleeps before its first batch); later waits,
    behind a slow consumer, find their item queued."""
    def source():
        time.sleep(0.2)
        yield from _batches(3)

    with _profile() as prof:
        got = []
        for batch in _device_prefetch(source(), torch.device("cpu")):
            got.append(batch)
            time.sleep(0.1)
    assert len(got) == 3
    names = [s[0] for s in _cut_spans(prof, tmp_path)]
    assert names == ["cut.feed.starved"] + ["cut.feed.get"] * 3


def test_profiled_steps_match_unprofiled_bitwise():
    """Two steps with the profiler recording and two without, from the same
    weights, generator and batches: the same losses and parameters, bit for
    bit."""
    batches = _batches()
    plain, traced = _trainer(), _trainer()
    losses = _steps(plain, batches)
    with _profile():
        traced_losses = _steps(traced, batches)
    assert losses == traced_losses
    for (name, a), (_, b) in zip(plain.model.named_parameters(), traced.model.named_parameters()):
        assert torch.equal(a, b), name
