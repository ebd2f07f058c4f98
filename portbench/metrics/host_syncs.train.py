"""host_syncs.train: the runtime calls that block the host until the
device catches up (`cudaStreamSynchronize`, `cudaDeviceSynchronize`,
`cudaEventSynchronize`, the blocking `cudaMemcpy`) that start inside a
`cut.train.step`, per traced step."""

from portbench.metrics import _spans


def read(reading, ctx):
    return _spans.calls_per_step(reading, _spans.SYNCS)
