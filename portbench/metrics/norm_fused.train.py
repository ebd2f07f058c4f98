"""norm_fused.train: DeepLabV3's norm chain kernels' launches in the
traced epoch (device kernels whose names hold `conv_epilogue_fwd`,
`conv_epilogue_bwd`, `norm_tail_fwd` or `norm_tail_bwd`,
contouring_uncertainty_torch/csrc/conv_epilogue.cu) over one forward and
one backward a norm a traced step, in %: 100 where every norm chain after
a convolution (GroupNorm and ReLU; a bottleneck's norm, channel dropout,
residual add and ReLU) ran as two kernels, 0 where it ran op by op.
DeepLabV3 has 1 + 3 x sum(layers) + 4 + (3 + 3) + 1 norms: the stem, three
a bottleneck, the four stages' projections, ASPP's five branches and its
projection (three atrous rates), and the head; 60 for layers [3, 4, 6, 3]."""

from portbench.metrics import _spans

KERNELS = ("conv_epilogue_fwd", "conv_epilogue_bwd", "norm_tail_fwd", "norm_tail_bwd")
RATES = 3  # ASPP's atrous rates (12, 24, 36)


def norms(layers) -> int:
    """The GroupNorms of a DeepLabV3 of `layers` bottlenecks a stage."""
    return 1 + 3 * sum(layers) + len(layers) + (RATES + 3) + 1


def read(reading, ctx):
    steps = _spans.steps(reading)
    if steps is None:
        return None
    launches = sum(len(reading.kernels(name)) for name in KERNELS)
    return 100.0 * launches / (len(steps) * 2 * norms(ctx.config["model"]["layers"]))
