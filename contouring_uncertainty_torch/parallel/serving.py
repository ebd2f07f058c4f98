"""Serving on several ranks: the sample axis split over a process group,
and the data-parallel forward.

Counterpart of contouring_uncertainty_tpu/parallel/serving.py. JAX marks
the Monte-Carlo sample axis with a sharding constraint and lets its
partitioner split the chain behind it; here the split is explicit. A
`SampleShard` gives this rank its part of a sample axis (`part`, `take`,
the views' generators cut to it by `row_blocks`) and puts the parts back
together in order (`gather`), so code that runs on a part and then
gathers returns what one process returns:

- the latency mode (`AleatoricPredictor.__call__` / `SegPredictor.__call__`
  with a mesh): one view's sample chain over every rank of the mesh;
- the composed mode (`batched` with `predict_sample_parallel` = s > 1):
  views over the data axis, each view's chain over the model axis.

What is split, in both: the MC-dropout forward's T_e*N rows, in whole
blocks of `tasks/dsnt_al.py mc_block_rows` rows (one process runs the
same blocks one after another, so every rank's convolutions see one
process's shapes), each rank's DSNT head on its rows, its (mu, Sigma)
gathered; then each rank's share of the T_a samples per prediction
through the sampler (its rows of every draw) and the rasterizer, the
samples and masks gathered. The encoder prefix (batch N) and the
sampler's per-prediction operators run whole on every rank.

An axis that does not divide the group is split unevenly, in whole
blocks, as `torch.tensor_split` splits it (the first parts one block
longer), where JAX pads it. With fewer blocks than ranks the last ranks
get empty parts: no tail rows (and no K2 launch), no samples (and no K3
launch); they still make the view's draws, so every rank's generators
stay where one process's are.

`sharded_forward` runs a forward data-parallel: each rank its block of the
batch, the outputs all-gathered.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from contouring_uncertainty_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, replicate
from contouring_uncertainty_torch.rng import row_block


class SampleShard:
    """This rank's part of a sample axis split over `group` (k ranks, this
    one `index`); with k == 1 `take` and `gather` return their input.

    An axis of n splits in whole blocks of `block` entries (1: single
    samples), dealt out as torch.tensor_split deals the n / block blocks
    (the first ones one block longer where k does not divide them; the
    last ranks none where there are fewer blocks than ranks)."""

    def __init__(self, group=None, index: int = 0, k: int = 1):
        self.group, self.index, self.k = group, index, k

    def part(self, n: int, block: int = 1) -> slice:
        """This rank's range of a sample axis of n in blocks of `block`."""
        if n % block:
            raise ValueError(f"a sample axis of {n} does not split in blocks of {block}")
        base, extra = divmod(n // block, self.k)
        start = self.index * base + min(self.index, extra)
        return slice(start * block, (start + base + (self.index < extra)) * block)

    def take(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        p = self.part(x.shape[dim])
        return x.narrow(dim, p.start, p.stop - p.start)

    def row_blocks(self, generators: Sequence, n: int, axis: int) -> list:
        """Each view's generator cut to this rank's rows of a sample axis of
        n on the draws' `axis` (rng.RowBlock); the generators themselves
        with k == 1."""
        if self.k == 1:
            return generators
        return [row_block(g, self.part(n), n, axis) for g in generators]

    def gather(self, x: torch.Tensor, dim: int, n: int, block: int = 1) -> torch.Tensor:
        """Every rank's part (this one `x`) of a sample axis of n at `dim`,
        concatenated in rank order on x's device: the whole axis. Parts
        travel padded to the longest one (all_gather takes equal shapes),
        an empty part too."""
        if self.k == 1:
            return x
        dim = dim % x.ndim
        sizes = [SampleShard(None, i, self.k).part(n, block) for i in range(self.k)]
        longest = max(s.stop - s.start for s in sizes)
        pad = list(x.shape)
        pad[dim] = longest - x.shape[dim]
        send = torch.cat([x, x.new_zeros(pad)], dim=dim) if pad[dim] else x
        send = send.contiguous()
        parts = [torch.empty_like(send) for _ in range(self.k)]
        dist.all_gather(parts, send, group=self.group)
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

