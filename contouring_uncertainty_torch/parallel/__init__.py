"""Several GPUs through torch.distributed, one process per GPU: the process
group and its launcher (.distributed), the (data, model) rank mesh with
batch sharding (.mesh), and the split sample axis of multi-rank serving
with the data-parallel forward (.serving)."""

from contouring_uncertainty_torch.parallel.distributed import (
    initialize as distributed_initialize,
    process_batch_slice,
    shard_host_batch,
    spawn,
)
from contouring_uncertainty_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from contouring_uncertainty_torch.parallel.serving import (
    SampleShard,
    sample_shard,
    sharded_forward,
)
