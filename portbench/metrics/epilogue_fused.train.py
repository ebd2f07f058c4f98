"""epilogue_fused.train: the ConvLayer epilogue kernels' launches in the
traced epoch (device kernels whose names hold `conv_epilogue_fwd` or
`conv_epilogue_bwd`, contouring_uncertainty_torch/csrc/conv_epilogue.cu)
over one forward and one backward a ConvLayer a traced step, in %: 100
where every ConvLayer's chain after its convolution ran as the two
kernels, 0 where it ran op by op. The UNet has 2 x (2 x stages - 1)
ConvLayers, its stages the configuration's `strides`."""

from portbench.metrics import _spans

KERNELS = ("conv_epilogue_fwd", "conv_epilogue_bwd")


def read(reading, ctx):
    steps = _spans.steps(reading)
    if steps is None:
        return None
    layers = 2 * (2 * len(ctx.config["model"]["strides"]) - 1)
    launches = sum(len(reading.kernels(name)) for name in KERNELS)
    return 100.0 * launches / (len(steps) * 2 * layers)
