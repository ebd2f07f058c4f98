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

A `RowBlock` in place of a generator (alone, or as one of the V) stands for
rows [start, stop) of a batch of `total` rows: a draw whose row axis holds
those rows is drawn for the whole batch and cut to them. The row axis is
the block's `axis`, or else the draw site's `batch_axis` (0 unless the
site says otherwise). Ranks that split a batch (data-parallel training,
the MC-dropout rows and the T_a samples of a view served over several
ranks) then draw, between them, exactly what one process draws for the
whole batch, and each leaves its generator where one process's is left. A
block of no rows (a rank with no share) still makes the whole draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch


class RowBlock:
    """Rows `rows` (a slice with a start and a stop) of every draw made for
    a batch of `total` rows from `generator`, on the draw's `axis` (None:
    the draw site's `batch_axis`). An axis of runs * (stop - start) entries
    holds those rows of each of `runs` batches laid end to end (the
    samples of several predictions flattened into one axis); `runs` is
    read from the draw's shape, and must be given where the block has no
    rows (None: one run)."""

    def __init__(self, generator: Optional[torch.Generator], rows: slice, total: int,
                 axis: Optional[int] = None, runs: Optional[int] = None):
        self.generator, self.rows, self.total = generator, rows, total
        self.axis, self.runs = axis, runs

    @property
    def device(self) -> torch.device:
        return self.generator.device if self.generator is not None else torch.device("cpu")

    def draw(self, draw_whole: Callable, shape, batch_axis: int) -> torch.Tensor:
        """`draw_whole(generator, whole_shape)` for the whole batch, cut to
        this block's rows of `shape`."""
        axis = (self.axis if self.axis is not None else batch_axis) % len(shape)
        rows = self.rows.stop - self.rows.start
        runs = self.runs if self.runs is not None else shape[axis] // rows if rows else 1
        if rows < 0 or shape[axis] != runs * rows:
            raise ValueError(f"a draw of shape {tuple(shape)} does not hold the {rows} rows of "
                             f"its row block on axis {axis}")
        whole = list(shape)
        whole[axis] = runs * self.total
        out = draw_whole(self.generator, whole).unflatten(axis, (runs, self.total))
        return out.narrow(axis + 1, self.rows.start, rows).flatten(axis, axis + 1)


def row_block(generator: Optional[torch.Generator], rows: slice, total: int,
              axis: Optional[int] = None):
    """`generator` itself when `rows` are all `total` rows, else its RowBlock."""
    if rows.start == 0 and rows.stop == total:
        return generator
    return RowBlock(generator, rows, total, axis)


def on_axis(generators: "Generators", axis: int, runs: int) -> "Generators":
    """The same generators with every RowBlock's rows moved to `axis`, where
    they lie in each of `runs` batches laid end to end, split over the
    generators as the draw is (a draw site whose row axis is another one,
    e.g. the samples of each of `runs` predictions flattened into axis 0)."""
    many = isinstance(generators, (list, tuple))
    each = runs // len(generators) if many else runs
    move = lambda g: (RowBlock(g.generator, g.rows, g.total, axis, each)
                      if isinstance(g, RowBlock) else g)
    return [move(g) for g in generators] if many else move(generators)


def rewinder(generator: "Generators") -> Callable[[], None]:
    """A function that puts `generator` (None: torch's default generator; a
    RowBlock: its generator) back where it is now."""
    g = generator.generator if isinstance(generator, RowBlock) else generator
    if g is None:
        state = torch.get_rng_state()
        return lambda: torch.set_rng_state(state)
    state = g.get_state()
    return lambda: g.set_state(state)


Generators = Union[None, torch.Generator, RowBlock, Sequence[Union[torch.Generator, RowBlock]]]


def _draw(fn: Callable, generators: Generators, shape, dtype: torch.dtype,
          device: Optional[torch.device], batch_axis: int = 0) -> torch.Tensor:
    shape = tuple(shape)
    one = lambda g, s: _draw(fn, g, s, dtype, None, batch_axis)
    if isinstance(generators, RowBlock):
        out = generators.draw(one, shape, batch_axis)
    else:
        gens = [generators] if generators is None or isinstance(generators, torch.Generator) \
            else list(generators)
        if len(gens) > 1 and (not shape or shape[0] % len(gens)):
            raise ValueError(f"a draw of shape {shape} cannot be split over {len(gens)} "
                             "generators")
        block = shape if len(gens) == 1 else (shape[0] // len(gens), *shape[1:])
        parts = [g.draw(one, block, batch_axis) if isinstance(g, RowBlock)
                 else fn(block, generator=g, dtype=dtype,
                         device=g.device if g is not None else torch.device("cpu"))
                 for g in gens]
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
