"""Random draws from the caller's generators, one generator per view.

Every random number of the port comes from a `torch.Generator` that the
caller passes. A draw site takes `Generators`: None (torch's default
generator), one generator, or a sequence of V generators. With V
generators the draw's first axis is split into V equal blocks, block v is
drawn from generator v, and the blocks are concatenated. A batch of V views
laid out view-major along that axis then consumes each view's generator as
the view alone would: the same numbers in the same order, so batching views
does not change what is drawn.

Numbers are drawn on each generator's device (the CPU without one) and
moved to the requested device, so a CPU generator gives the same draws on
every device.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

Generators = Union[None, torch.Generator, Sequence[torch.Generator]]


def _draw(fn: Callable, generators: Generators, shape, dtype: torch.dtype,
          device: Optional[torch.device]) -> torch.Tensor:
    shape = tuple(shape)
    gens = [generators] if generators is None or isinstance(generators, torch.Generator) \
        else list(generators)
    if len(gens) > 1 and (not shape or shape[0] % len(gens)):
        raise ValueError(f"a draw of shape {shape} cannot be split over {len(gens)} generators")
    block = shape if len(gens) == 1 else (shape[0] // len(gens), *shape[1:])
    parts = [fn(block, generator=g, dtype=dtype,
                device=g.device if g is not None else torch.device("cpu")) for g in gens]
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    return out if device is None else out.to(device)


def draw_normal(generators: Generators, shape, dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """Standard normals of `shape`."""
    return _draw(torch.randn, generators, shape, dtype, device)


def draw_uniform(generators: Generators, shape, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Uniforms on [0, 1) of `shape`."""
    return _draw(torch.rand, generators, shape, dtype, device)
