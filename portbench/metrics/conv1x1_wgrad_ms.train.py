"""conv1x1_wgrad_ms.train: the device time of the 1x1 convolutions' weight
gradient kernels (device kernels whose names hold `conv1x1_wgrad`: the
split-K kernel and its reduce pass,
contouring_uncertainty_torch/csrc/conv1x1_wgrad.cu) in the traced epoch,
mean per traced step, in ms; nothing where the trace holds no launch of
them (those gradients then run in cuDNN, whose kernels no name sets apart)."""

from portbench.metrics import _spans

NEEDLE = "conv1x1_wgrad"


def read(reading, ctx):
    steps = _spans.steps(reading)
    times = reading.kernels(NEEDLE) if steps is not None else []
    if not times:
        return None
    return 1e3 * sum(times) / len(steps)
