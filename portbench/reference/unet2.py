"""The backbone `unet2` (the 8-stage nnU-Net of `task/model/unet2.json`,
with `drop_block`): its plain-PyTorch forward over a state dict of the
benchmark's weights, its published initialisation rule, and the FLOPs of
one training image from its layer shapes.

Every backbone a configuration names by `model_name` has a module
`reference/<model_name>.py` with these three, found by that name:

- `forward(w, x, model, drop)`: logits (B, K, H, W) of x (B, C, H, W),
  `model` the configuration's `model` section, `drop(shape)` the
  uniforms of a dropout layer (None: dropout off);
- `init(name, shape)`: how the leaf is initialised, ("normal", variance)
  for flax's truncated normal of that variance, or ("constant", value);
- `train_flops(in_shape, n_classes, model)`: the FLOPs of one image's
  forward and backward.

The published network: per encoder stage two 3x3 convolutions (the first
with the stage's stride, padding 1), each followed by [channel dropout
p = 0.5 in the two deepest encoder stages and the bottleneck] -> instance
norm (eps 1e-5, affine) -> LeakyReLU(0.01); filters min(2^(5+i), 480);
per decoder stage a 2x2 stride-2 transposed convolution without bias, the
skip concatenated after the upsampled tensor, two 3x3 convolutions; a 1x1
head without bias. The weights are the state dict's, read by the
program's parameter names.

Channel dropout draws, per dropout layer in execution order, one uniform
per (row, channel) from the caller's generator and keeps the channel where
it is below 0.5, scaled by 2.

The initialisation: flax's variance scaling, truncated normal, fan in,
scale 2 / (1 + 0.01^2) for LeakyReLU(0.01) on every convolution; zero
biases; unit instance-norm scales.

The FLOPs count what `torch.utils.flop_counter` counts for the UNet: two
per multiply-add of every convolution and transposed convolution (a
forward; the backward's input and weight gradients, with no input
gradient for the stem, whose input needs none). Instance norm, the
activations and the DSNT head are not counted. A CPU test holds these
counts to `flop_counter` on the program's model.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.work import ConvShape, conv_flops

Weights = Dict[str, torch.Tensor]

_SCALE = 2.0 / (1.0 + 0.01 ** 2)


def drop_stages(n_stages: int) -> List[bool]:
    """Which encoder stages (0 .. n_stages - 1, the last the bottleneck)
    carry dropout: the two deepest before the bottleneck and the bottleneck."""
    n_down = n_stages - 2
    return [1 <= i <= n_down and (n_down - (i - 1)) <= 2 or i == n_down + 1
            for i in range(n_stages)]


def _conv_layer(w: Weights, name: str, x, stride: int, drop: Optional[Callable]):
    x = F.conv2d(x, w[f"{name}.Conv_0.weight"], w[f"{name}.Conv_0.bias"], stride, 1)
    if drop is not None:
        keep = drop((x.shape[0], x.shape[1], 1, 1)).to(x.device) < 0.5
        x = torch.where(keep, x / 0.5, torch.zeros((), dtype=x.dtype, device=x.device))
    x = F.instance_norm(x, weight=w[f"{name}.InstanceNorm_0.weight"],
                        bias=w[f"{name}.InstanceNorm_0.bias"], eps=1e-5)
    return F.leaky_relu(x, 0.01)


def _block(w: Weights, name: str, x, stride: int, drop: Optional[Callable]):
    x = _conv_layer(w, f"{name}.ConvLayer_0", x, stride, drop)
    return _conv_layer(w, f"{name}.ConvLayer_1", x, 1, drop)


def decoder(w: Weights, x, skips: list):
    """Upsample blocks over the skips (deepest first) and the 1x1 head."""
    for j, skip in enumerate(reversed(skips)):
        x = F.conv_transpose2d(x, w[f"UpsampleBlock_{j}.ConvTranspose_0.weight"], stride=2)
        x = torch.cat([x, skip], dim=1)
        x = _block(w, f"UpsampleBlock_{j}.ConvBlock_0", x, 1, None)
    return F.conv2d(x, w["OutputBlock_0.Conv_0.weight"])


def forward(w: Weights, x, model: Dict, drop: Optional[Callable] = None):
    """The whole network on x (B, C, H, W) -> logits (B, K, H, W), its
    stages those of `model["strides"]`. `drop(shape)` draws the uniforms
    of a dropout layer (None: dropout off)."""
    skips = []
    for i, dropped in enumerate(drop_stages(len(model["strides"]))):
        x = _block(w, f"ConvBlock_{i}", x, 1 if i == 0 else 2, drop if dropped else None)
        skips.append(x)
    return decoder(w, x, skips[:-1])


def init(name: str, shape: Sequence[int]) -> Tuple[str, float]:
    """Convolutions (out, in, kh, kw) and transposed convolutions (in, out,
    kh, kw) draw at the LeakyReLU scale over their fan in, in * kh * kw (a
    transposed convolution's "in" is dim 0); instance-norm scales are one,
    every other leaf zero."""
    if name.endswith(".weight") and len(shape) == 4:
        fan_in = (shape[0] if "ConvTranspose" in name else shape[1]) * shape[2] * shape[3]
        return "normal", _SCALE / fan_in
    return "constant", 1.0 if name.endswith("InstanceNorm_0.weight") else 0.0


def unet_filters(n_stages: int) -> List[int]:
    """Filters of the program's UNet stage i: min(2^(5+i), 480)."""
    return [min(2 ** (5 + i), 480) for i in range(n_stages)]


def unet_convs(in_shape: Sequence[int], n_classes: int, kernels, strides) -> List[ConvShape]:
    """Every convolution of the UNet, in execution order: per encoder stage
    two 3x3 convolutions (the first strided), a bottleneck stage at the last
    stride, per upsample block a transposed convolution and two 3x3
    convolutions over [upsampled, skip], and the 1x1 head."""
    c, h, w = in_shape
    filters = unet_filters(len(strides))
    n_down = len(filters) - 2
    out, sizes, enc = [], [], []
    for idx in range(n_down + 2):
        f = filters[idx] if idx <= n_down else filters[-1]
        (kh, kw), (sh, sw) = kernels[idx], strides[idx]
        h = (h + 2 * (kh // 2) - kh) // sh + 1
        w = (w + 2 * (kw // 2) - kw) // sw + 1
        out.append(ConvShape(f"enc{idx}", c, f, kh, kw, h, w))
        out.append(ConvShape(f"enc{idx}", f, f, kh, kw, h, w))
        sizes.append((h, w))
        enc.append(f)
        c = f
    skips = list(zip(enc[:-1], sizes[:-1]))[::-1]
    up_filters = filters[:-1][::-1]
    up_kernels = list(kernels[1:])[::-1]
    up_strides = list(strides[1:])[::-1]
    for j, (c_skip, (hs, ws)) in enumerate(skips):
        f = up_filters[j]
        sh, sw = up_strides[j]
        out.append(ConvShape(f"dec{j}", c, f, sh, sw, h, w))  # transposed, over its input
        h, w = hs, ws
        kh, kw = up_kernels[j]
        out.append(ConvShape(f"dec{j}", f + c_skip, f, kh, kw, h, w))
        out.append(ConvShape(f"dec{j}", f, f, kh, kw, h, w))
        c = f
    out.append(ConvShape("head", c, n_classes, 1, 1, h, w))
    return out


def unet_train_flops(convs: List[ConvShape]) -> float:
    """Forward and backward of one image: the forward, each convolution's
    weight gradient, and each input gradient but the stem's."""
    fwd = sum(conv_flops(c) for c in convs)
    return 3.0 * fwd - conv_flops(convs[0])


def train_flops(in_shape: Sequence[int], n_classes: int, model: Dict) -> float:
    """The FLOPs of one training image at the configuration's stages."""
    return unet_train_flops(unet_convs(in_shape, n_classes, model["kernels"], model["strides"]))
