"""launches.train: the kernel launches (`cudaLaunchKernel`,
`cudaLaunchKernelExC`, `cuLaunchKernel`, `cuLaunchKernelEx`) that start
inside a `cut.train.step`, per traced step."""

from portbench.metrics import _spans


def read(reading, ctx):
    return _spans.calls_per_step(reading, _spans.LAUNCHES)
