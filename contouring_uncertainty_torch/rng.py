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

A `RowBlock` in place of a generator stands for rows [start, stop) of a
batch of `total` rows: a draw whose batch axis (`batch_axis`, 0 unless the
draw site says otherwise) holds those rows is drawn for the whole batch
and cut to them. Ranks that split a batch (data-parallel training, the
rows of a sharded Monte-Carlo forward) then draw, between them, exactly
what one process draws for the whole batch.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch



class RowBlock:
    """Rows `rows` (a slice with a start and a stop) of every draw made for
    a batch of `total` rows from `generator`."""

    def __init__(self, generator: Optional[torch.Generator], rows: slice, total: int):
        self.generator, self.rows, self.total = generator, rows, total

    @property
    def device(self) -> torch.device:
        return self.generator.device if self.generator is not None else torch.device("cpu")


def row_block(generator: Optional[torch.Generator], rows: slice, total: int):
    """`generator` itself when `rows` are all `total` rows, else its RowBlock."""
    if rows.start == 0 and rows.stop == total:
        return generator
    return RowBlock(generator, rows, total)


Generators = Union[None, torch.Generator, RowBlock, Sequence[torch.Generator]]


def _draw(fn: Callable, generators: Generators, shape, dtype: torch.dtype,
          device: Optional[torch.device], batch_axis: int = 0) -> torch.Tensor:
    shape = tuple(shape)
    if isinstance(generators, RowBlock):
        block = generators
        rows = block.rows.stop - block.rows.start
        if shape[batch_axis] != rows:
            raise ValueError(f"a draw of shape {shape} does not hold the {rows} rows of its "
                             f"row block on axis {batch_axis}")
        whole = list(shape)
        whole[batch_axis] = block.total
        out = _draw(fn, block.generator, whole, dtype, None)
        out = out.narrow(batch_axis, block.rows.start, rows)
        return out if device is None else out.to(device)
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
                device: Optional[torch.device] = None, batch_axis: int = 0) -> torch.Tensor:
    """Standard normals of `shape`."""
    return _draw(torch.randn, generators, shape, dtype, device, batch_axis)


def draw_uniform(generators: Generators, shape, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None, batch_axis: int = 0) -> torch.Tensor:
    """Uniforms on [0, 1) of `shape`."""
    return _draw(torch.rand, generators, shape, dtype, device, batch_axis)
