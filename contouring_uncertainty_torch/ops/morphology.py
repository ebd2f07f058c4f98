"""Binary morphology on the device: hole filling and the largest connected
component, batched over any leading axes.

Counterpart of contouring_uncertainty_tpu/ops/morphology.py (`fill_holes`,
`largest_blob`, `postprocess_sample`, `postprocess_batch`), the
post-processing of the segmentation baselines' sample masks. Both are
fixed points of 4-neighbour propagation (a vertical and a horizontal
3-tap max pool per step), iterated over the whole batch at once:

- `fill_holes`: the background 4-connected to the image border grows from
  the border pixels that are background; every pixel it does not reach is
  foreground.
- `largest_blob`: every foreground pixel starts with its own label
  `row * W + col + 1` and takes the largest label of its 4-neighbours in
  its component until nothing changes; a component's label is then its
  largest pixel id. The component kept is the largest, and among equal
  sizes the one with the smallest label (the first maximum over sizes
  indexed by label, as `jnp.argmax` takes it). An empty mask stays empty.

Both propagations only grow (a pixel joins the outside, a label rises), so
a batch whose state did not move over `CHECK_EVERY` iterations is at its
fixed point, and iterations past a mask's convergence change nothing:
convergence is read from the device once per `CHECK_EVERY` iterations,
not once per iteration. `iterations` holds the iteration counts of the
last call of each function.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

CHECK_EVERY = 8  # iterations between two reads of the convergence flag
iterations: Dict[str, int] = {"fill_holes": 0, "largest_blob": 0}


def _cross_max(x: torch.Tensor) -> torch.Tensor:
    """The largest of each pixel of non-negative (B, H, W) `x` and its four
    neighbours (nothing outside the image): a vertical and a horizontal
    3-tap max pool."""
    x = x[:, None]
    v = F.max_pool2d(x, (3, 1), stride=1, padding=(1, 0))
    h = F.max_pool2d(x, (1, 3), stride=1, padding=(0, 1))
    return torch.maximum(v, h)[:, 0]


def _fixed_point(state: torch.Tensor, step, name: str) -> torch.Tensor:
    n = 0
    while True:
        before = state
        for _ in range(CHECK_EVERY):
            state = step(state)
        n += CHECK_EVERY
        if torch.equal(state, before):
            iterations[name] = n
            return state


def _flat(mask: torch.Tensor):
    return (mask > 0).reshape(-1, *mask.shape[-2:])


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """Fill the enclosed background of binary (..., H, W) masks; the
    result has the mask's dtype."""
    fg = _flat(mask)
    border = torch.ones_like(fg[0])
    border[1:-1, 1:-1] = False
    outside = (border & ~fg).to(torch.float32)
    not_fg = (~fg).to(torch.float32)
    outside = _fixed_point(outside, lambda o: _cross_max(o) * not_fg, "fill_holes")
    return (fg | (outside == 0)).reshape(mask.shape).to(mask.dtype)


def largest_blob(mask: torch.Tensor) -> torch.Tensor:
    """Keep the largest 4-connected component of binary (..., H, W) masks
    (ties: the smallest label); the result has the mask's dtype."""
    fg = _flat(mask)
    b, h, w = fg.shape
    if h * w >= 2 ** 24:  # labels are f32, exact up to 2^24
        raise ValueError(f"largest_blob labels a {h}x{w} image in f32: at most 2^24 pixels")
    ids = torch.arange(1, h * w + 1, dtype=torch.float32, device=fg.device).reshape(h, w)
    fg_f = fg.to(torch.float32)
    labels = _fixed_point(ids * fg_f, lambda lab: _cross_max(lab) * fg_f, "largest_blob")
    offsets = torch.arange(b, device=fg.device, dtype=torch.int64)[:, None] * (h * w + 1)
    sizes = torch.bincount((labels.reshape(b, -1).to(torch.int64) + offsets).reshape(-1),
                           minlength=b * (h * w + 1)).reshape(b, h * w + 1)
    sizes[:, 0] = 0  # the background is no component
    best = sizes.argmax(dim=1).to(torch.float32)
    keep = (labels == best[:, None, None]) & fg
    return keep.reshape(mask.shape).to(mask.dtype)


def postprocess_sample(mask: torch.Tensor) -> torch.Tensor:
    """fill_holes, then largest_blob (the reference's per-sample chain)."""
    return largest_blob(fill_holes(mask))


def postprocess_batch(masks: torch.Tensor) -> torch.Tensor:
    """`postprocess_sample` of every (H, W) mask of (..., H, W), of none
    (a rank dealt no samples) too."""
    return postprocess_sample(masks) if masks.numel() else masks.clone()
