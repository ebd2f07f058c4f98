"""Plain-PyTorch forward of the 8-stage nnU-Net of `task/model/unet2.json`
with `drop_block`, over a state dict of the benchmark's weights.

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
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


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


def forward(w: Weights, x, n_stages: int, drop: Optional[Callable] = None):
    """The whole network on x (B, C, H, W) -> logits (B, K, H, W).
    `drop(shape)` draws the uniforms of a dropout layer (None: dropout
    off)."""
    skips = []
    for i, dropped in enumerate(drop_stages(n_stages)):
        x = _block(w, f"ConvBlock_{i}", x, 1 if i == 0 else 2, drop if dropped else None)
        skips.append(x)
    return decoder(w, x, skips[:-1])
