"""The benchmark's weights, made from the run's seed on the device.

The published initialisation of the UNet (flax's variance scaling,
truncated normal, fan in, scale 2 / (1 + 0.01^2) for LeakyReLU(0.01);
zero biases; unit norm scales), drawn with a generator on the weights'
device in one call for every convolution at once: the truncated normal is
the inverse normal CDF of uniforms on [Phi(-2), Phi(2)], scaled per
tensor. Both the program and the plain reference take these tensors.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

_SCALE = 2.0 / (1.0 + 0.01 ** 2)
_TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated at +-2


def make(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> shape (the model's state dict) to name -> f32 tensor on `device`."""
    device = torch.device(device)
    convs = {k: s for k, s in shapes.items() if k.endswith(".weight") and len(s) == 4}
    total = sum(math.prod(s) for s in convs.values())
    g = torch.Generator(device=device).manual_seed(int(seed))
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.rand(total, generator=g, device=device, dtype=torch.float64) * (hi - lo) + lo
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).to(torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in convs:
            # Conv (out, in, kh, kw) and ConvTranspose (in, out, kh, kw): the
            # fan in is in * kh * kw; a transposed convolution's "in" is dim 0.
            fan_in = (shape[0] if "ConvTranspose" in name else shape[1]) * shape[2] * shape[3]
            std = math.sqrt(_SCALE / fan_in) / _TRUNC_STD
            n = math.prod(shape)
            out[name] = (z[at:at + n] * std).reshape(shape)
            at += n
        elif name.endswith("InstanceNorm_0.weight"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
