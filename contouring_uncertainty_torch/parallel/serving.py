"""Serving on several ranks: the sample axis split over a process group,
and the data-parallel forward.

Counterpart of contouring_uncertainty_tpu/parallel/serving.py. JAX marks
the Monte-Carlo sample axis with a sharding constraint and lets its
partitioner split the chain behind it; here the split is explicit. A
`SampleShard` gives this rank its part of a sample axis (`take`) and puts
the parts back together in order (`gather`), so code that runs on a part
and then gathers returns what one process returns:

- the latency mode (`AleatoricPredictor.__call__` / `SegPredictor.__call__`
  with a mesh): one view's sample chain over every rank of the mesh;
- the composed mode (`batched` with `predict_sample_parallel` = s > 1):
  views over the data axis, each view's chain over the model axis.

A sample axis of n that does not divide the group is split unevenly, as
`torch.tensor_split` splits it (the first n % k parts one longer), where
JAX pads it.

`sharded_forward` runs a forward data-parallel: each rank its block of the
batch, the outputs all-gathered.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from contouring_uncertainty_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, replicate


class SampleShard:
    """This rank's part of a sample axis split over `group` (k ranks, this
    one `index`); with k == 1 `take` and `gather` return their input."""

    def __init__(self, group=None, index: int = 0, k: int = 1):
        self.group, self.index, self.k = group, index, k

    def part(self, n: int) -> slice:
        """This rank's range of a sample axis of n, as torch.tensor_split."""
        base, extra = divmod(n, self.k)
        start = self.index * base + min(self.index, extra)
        return slice(start, start + base + (self.index < extra))

    def take(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        p = self.part(x.shape[dim])
        return x.narrow(dim, p.start, p.stop - p.start)

    def gather(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """Every rank's part (this one `x`) of a sample axis of n at `dim`,
        concatenated in rank order on x's device: the whole axis. Parts
        travel padded to the longest one (all_gather takes equal shapes)."""
        if self.k == 1:
            return x
        dim = dim % x.ndim
        longest = -(-n // self.k)
        pad = list(x.shape)
        pad[dim] = longest - x.shape[dim]
        send = torch.cat([x, x.new_zeros(pad)], dim=dim) if pad[dim] else x
        send = send.contiguous()
        parts = [torch.empty_like(send) for _ in range(self.k)]
        dist.all_gather(parts, send, group=self.group)
        sizes = [SampleShard(None, i, self.k).part(n) for i in range(self.k)]
        return torch.cat([p.narrow(dim, 0, s.stop - s.start) for p, s in zip(parts, sizes)],
                         dim=dim)


NO_SHARD = SampleShard()


def sample_shard(mesh: Optional[Mesh], axes: Sequence[str] = (DATA_AXIS, MODEL_AXIS)
                 ) -> SampleShard:
    """The shard of a sample axis split over the mesh's `axes` (by default
    every rank; (MODEL_AXIS,) for the composed mode). NO_SHARD without a
    mesh or over one rank."""
    if mesh is None:
        return NO_SHARD
    axes = tuple(a for a in axes if mesh.shape[a] > 1)
    if not axes:
        return NO_SHARD
    if len(axes) == 2:
        return SampleShard(mesh.group(), mesh.rank, mesh.size)
    return SampleShard(mesh.group(axes[0]), mesh.index(axes[0]), mesh.shape[axes[0]])


def sharded_forward(forward_fn: Callable, model: torch.nn.Module, mesh: Mesh
                    ) -> Tuple[Callable, torch.nn.Module]:
    """`forward_fn(model, img)` data-parallel over the mesh's data axis.

    Returns (fn, model): the model with rank 0's weights on every rank
    (replicated once, not per call), and fn(model, img), which runs the
    forward on this rank's block of the batch and all-gathers the outputs
    (a tensor or a tuple of tensors) over the data axis, so every rank gets
    the whole batch's. Each rank's custom kernels see only its block.
    Requires batch % data size == 0 (callers pad ragged tails), else
    ValueError."""
    replicate(model, mesh)
    n = mesh.shape[DATA_AXIS]
    shard = SampleShard(mesh.group(DATA_AXIS), mesh.index(DATA_AXIS), n)

    def fn(model, img: torch.Tensor):
        if img.shape[0] % n:
            raise ValueError(
                f"sharded_forward: batch {img.shape[0]} not divisible by the mesh's {n}-way "
                "data axis — pad the batch")
        out = forward_fn(model, shard.take(img, 0))
        gather = lambda a: shard.gather(a, 0, img.shape[0])
        return tuple(gather(a) for a in out) if isinstance(out, tuple) else gather(out)

    return fn, model

