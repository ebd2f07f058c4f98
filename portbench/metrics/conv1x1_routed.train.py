"""conv1x1_routed.train: the split-K weight gradient kernel's launches in
the traced epoch (device kernels whose names hold `conv1x1_wgrad_kernel`,
contouring_uncertainty_torch/csrc/conv1x1_wgrad.cu; its reduce pass,
`conv1x1_wgrad_reduce_kernel`, not counted) over one a 1x1 convolution a
traced step, in %: 100 where every 1x1 convolution's weight gradient ran
on the kernel, 0 where each ran in cuDNN. DeepLabV3 has 2 x sum(layers) +
len(layers) + 3 + 1 1x1 convolutions: two a bottleneck, the four stages'
projections, ASPP's 1x1 branch, its pooled branch and its projection, and
the head's output; 40 for layers [3, 4, 6, 3]."""

from portbench.metrics import _spans

KERNEL = "conv1x1_wgrad_kernel"
ASPP_1X1 = 3  # ASPP's 1x1 branch, its pooled branch and its projection


def convs(layers) -> int:
    """The 1x1 convolutions of a DeepLabV3 of `layers` bottlenecks a stage."""
    return 2 * sum(layers) + len(layers) + ASPP_1X1 + 1


def read(reading, ctx):
    steps = _spans.steps(reading)
    if steps is None:
        return None
    launches = len(reading.kernels(KERNEL))
    return 100.0 * launches / (len(steps) * convs(ctx.config["model"]["layers"]))
