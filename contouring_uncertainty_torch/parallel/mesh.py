"""The rank mesh and batch sharding.

Counterpart of contouring_uncertainty_tpu/parallel/mesh.py. The JAX mesh
lays devices out (data, model) and XLA inserts the collectives; here the
ranks of the process group are laid out the same way, row-major (rank =
data_index * model + model_index), and the code that needs a collective
runs it on the mesh's process group for that axis:

- the data axis: ranks with the same model index, each with its own rows
  of a batch (data-parallel training, view-parallel serving);
- the model axis: ranks with the same data index, which split one view's
  Monte-Carlo sample chain (parallel/serving.py).

Parameters are replicated (`replicate`), batches sharded on their leading
axis (`shard_batch`). The UNet's instance norm and the other backbones'
group norm are per sample, so nothing needs a synchronised batch norm.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from contouring_uncertainty_torch.parallel.distributed import (
    DEFAULT_TIMEOUT_S,
    initialize,
    rank,
    world_size,
)

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """`shape` {data: d, model: s} over d * s ranks; this rank's `rank` and
    coordinates (`index`); `group(axis)`: the process group of the ranks
    along `axis` through this rank (None for an axis of one rank), and
    `group()` every rank's."""

    def __init__(self, data: int, model: int, groups: Dict[str, Optional[object]]):
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.rank = rank()
        self._groups = groups

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def index(self, axis: str) -> int:
        s = self.shape[MODEL_AXIS]
        return self.rank // s if axis == DATA_AXIS else self.rank % s

    def group(self, axis: Optional[str] = None):
        return self._groups[axis]

    def rows(self, n: int) -> slice:
        """This rank's rows of an evaluation or serving batch of n: its
        block of the data axis, or all n where n does not divide (a ragged
        batch goes whole to every rank, as the JAX mesh replicates it). A
        training batch is cut by `distributed.process_batch_slice`, which
        refuses a ragged one."""
        d = self.shape[DATA_AXIS]
        if n % d:
            return slice(0, n)
        i = self.index(DATA_AXIS)
        return slice(i * n // d, (i + 1) * n // d)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """The (data, model) mesh over every rank of the process group (one rank
    without one), `model_parallel` ranks on the model axis.

    Raises if fewer than `n_devices` ranks exist: a silently smaller mesh
    would let a "two-GPU" check pass vacuously in one process. A mesh spans
    every rank, so an `n_devices` below the group's size raises too. Every
    rank must call it, in the same order: it creates the axes' process
    groups (their collectives fail after DEFAULT_TIMEOUT_S)."""
    initialize()  # a process started by torchrun joins its group first
    world = world_size()
    if n_devices is not None and n_devices != world:
        if world < n_devices:
            raise ValueError(
                f"make_mesh({n_devices}) but only {world} rank(s) are in the process group; "
                "refusing to silently build a smaller mesh. Start one process per device "
                "(parallel.distributed.spawn or torchrun) first.")
        raise ValueError(f"make_mesh({n_devices}) in a process group of {world} ranks: a "
                         "mesh spans every rank")
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide the {world} ranks")
    d, s = world // model_parallel, model_parallel
    timeout = timedelta(seconds=DEFAULT_TIMEOUT_S)
    everyone = dist.group.WORLD if world > 1 else None

    def axis_groups(members: List[List[int]]):
        """The group of the members list that holds this rank, every list's
        group created on every rank in the same order."""
        if len(members[0]) == 1:
            return None
        if len(members[0]) == world:
            return everyone
        mine = None
        for ranks in members:
            g = dist.new_group(ranks, timeout=timeout)
            if rank() in ranks:
                mine = g
        return mine

    groups = {None: everyone,
              DATA_AXIS: axis_groups([[i * s + m for i in range(d)] for m in range(s)]),
              MODEL_AXIS: axis_groups([[i * s + m for m in range(s)] for i in range(d)])}
    return Mesh(d, s, groups)


def _numeric(value) -> bool:
    return (isinstance(value, np.ndarray) and value.ndim >= 1
            and np.issubdtype(value.dtype, np.number))


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows (`mesh.rows`) of every numeric array of a host
    batch; other entries as they are. A batch whose leading axis does not
    divide the data axis goes whole to every rank."""
    return {k: v[mesh.rows(len(v))] if _numeric(v) else v for k, v in batch.items()}


def replicate(module: torch.nn.Module, mesh: Mesh) -> bool:
    """Broadcast rank 0's parameters and buffers into every rank's
    `module`, in place. Returns whether every rank already held rank 0's
    values (the same answer on every rank): ranks that built their weights
    from one seed must, and False there means they did not."""
    if mesh.size == 1:
        return True
    same, device = True, torch.device("cpu")
    with torch.no_grad():
        for t in module.state_dict().values():
            ref = t.detach().clone()
            dist.broadcast(ref, src=0)
            same = same and torch.equal(ref, t)
            t.copy_(ref)
            device = t.device
    flag = torch.tensor([float(same)], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item() == 1.0)


def global_means(logs: List[Dict[str, torch.Tensor]], mesh: Mesh) -> List[Dict[str, float]]:
    """Per batch, the logs as means over the batch's global rows. `logs[b]`
    holds this rank's means over its rows (`mesh.rows`): an equal block of
    the batch, or the whole batch where it does not divide, so the global
    mean is the mean over the data axis, taken for every batch in one
    collective. Every rank gets the same values, so decisions taken on them
    (early stopping, the best checkpoint, a divergence abort) agree."""
    if not logs:
        return []
    keys = list(logs[0])
    local = torch.stack([torch.stack([l[k].detach().float() for k in keys]) for l in logs])
    d = mesh.shape[DATA_AXIS]
    if d > 1:
        local = local.to(torch.float64)
        dist.all_reduce(local, group=mesh.group(DATA_AXIS))
        local = local / d
    return [dict(zip(keys, row)) for row in local.cpu().tolist()]
