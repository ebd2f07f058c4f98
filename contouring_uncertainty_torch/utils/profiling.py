"""Phase timing, the model summary and the trace spans of a training run.

Counterpart of contouring_uncertainty_tpu/utils/profiling.py:

- `PhaseTimer`: accumulating wall-clock phases, each duration kept, with a
  `torch.cuda.synchronize()` at the end of each phase when `sync` is set (so
  a phase's time includes the device work it queued); written to
  `{name}_phases.json` beside the metrics CSV;
- `model_summary`: a parameter table (module, shape, count, total), the
  counterpart of the flax `tabulate` dump in `summary.txt`;
- `span`: a named span of the training path for `torch.profiler`, opened
  only while a profiler records the calling thread (else one shared null
  context, for one C call of about 0.1 us). Every name starts with `cut.`,
  and all open on the thread that runs the training loop:

  - `cut.feed.get`, `cut.feed.starved`: `train/trainer.py
    _device_prefetch`'s wait for each next item of its queue (a batch, or
    the epoch's end), when one was already queued or when it was empty;
  - `cut.train.step`: `Trainer.train_step`'s whole body, and inside it in
    turn `cut.train.augment` (the uint8 dequantise, the augmentation's
    draws and warp), `cut.train.zero_grad` (`model.train()`,
    `optimizer.zero_grad`), `cut.train.forward` (the task's loss: the
    model, its head and the NLL), `cut.train.backward` (`loss.backward()`;
    its ops run on the autograd engine's thread, inside this span's time)
    and `cut.train.update` (the gradients' all-reduce, the optimizer's
    update);
  - `cut.model.backbone`, `cut.model.aspp`, `cut.model.head`:
    `models/deeplabv3.py DeepLabV3.forward`'s ResNet backbone, its ASPP,
    and its heads (each head's 3x3 conv, norm, 1x1 conv, cast and bilinear
    upsampling), in turn; in training they open inside
    `cut.train.forward`. The UNet opens none. The profiler gives a span a
    device extent over the kernels launched while it is the innermost
    open span, so these take the model's kernels out of
    `cut.train.forward`'s extent.

  A profiler records the thread that started it: the feed's worker thread
  is not seen. The serving path opens only the model's spans, where its
  model is a DeepLabV3. A span changes no arithmetic.

The JAX `device_trace` is, here, `torch.profiler` around the call, which
these spans annotate.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List

import torch

_NULL = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled  # True on a thread a profiler records


def span(name: str):
    """`torch.profiler.record_function(name)` while a profiler records the
    calling thread, else a shared null context. `name` starts with `cut.`."""
    return torch.profiler.record_function(name) if _recording() else _NULL


class PhaseTimer:
    def __init__(self, sync: bool = False):
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.sync = sync

    @contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        yield
        if self.sync:
            torch.cuda.synchronize()
        self.samples[name].append(time.perf_counter() - start)

    def summary(self) -> Dict[str, Dict]:
        """Per phase: total seconds, count, mean and median ms, and every
        duration in ms in the order they were taken."""
        return {
            name: {
                "total_s": round(sum(s), 4),
                "count": len(s),
                "mean_ms": round(1000 * sum(s) / len(s), 3),
                "median_ms": round(1000 * statistics.median(s), 3),
                "samples_ms": [round(1000 * t, 3) for t in s],
            }
            for name, s in self.samples.items()
        }

    def dump(self, path: str | Path):
        Path(path).write_text(json.dumps(self.summary(), indent=2))


def model_summary(model: torch.nn.Module, input_shape) -> str:
    """One line per parameter (name, shape, count), then the total."""
    rows = [(name, tuple(p.shape), p.numel()) for name, p in model.named_parameters()]
    width = max((len(r[0]) for r in rows), default=10)
    lines = [f"{type(model).__name__}, input (N, {', '.join(map(str, input_shape))})",
             f"{'parameter':<{width}}  {'shape':<22} count"]
    lines += [f"{name:<{width}}  {str(shape):<22} {n}" for name, shape, n in rows]
    lines.append(f"total parameters: {sum(r[2] for r in rows)}")
    return "\n".join(lines) + "\n"
