"""The benchmark's weights, made from the run's seed on the device.

Each leaf is initialised by its backbone's published rule
(`reference/<model_name>.py init`): flax's variance scaling, truncated
normal, at the variance the rule gives, or a constant. Every drawn leaf
comes from one call on the weights' device, in the state dict's order:
the truncated normal is the inverse normal CDF of uniforms on
[Phi(-2), Phi(2)], scaled per tensor. Both the program and the plain
reference take these tensors.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch

_TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated at +-2

Init = Callable[[str, Sequence[int]], Tuple[str, float]]


def make(shapes: Dict[str, torch.Size], seed: int, device, init: Init) -> Dict[str, torch.Tensor]:
    """name -> shape (the model's state dict) to name -> f32 tensor on
    `device`, each leaf by `init(name, shape)`: ("normal", variance) or
    ("constant", value)."""
    device = torch.device(device)
    rules = {name: init(name, shape) for name, shape in shapes.items()}
    total = sum(math.prod(shapes[k]) for k, (kind, _) in rules.items() if kind == "normal")
    g = torch.Generator(device=device).manual_seed(int(seed))
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.rand(total, generator=g, device=device, dtype=torch.float64) * (hi - lo) + lo
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).to(torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        kind, value = rules[name]
        if kind == "normal":
            n = math.prod(shape)
            out[name] = (z[at:at + n] * (math.sqrt(value) / _TRUNC_STD)).reshape(shape)
            at += n
        elif kind == "constant":
            out[name] = torch.full(shape, value, device=device)
        else:
            raise ValueError(f"{name}: no initialisation {kind!r}")
    return out
