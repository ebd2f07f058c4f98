"""Normalized <-> pixel coordinate conventions for spatial-softmax point regression.

Counterpart of contouring_uncertainty_tpu/ops/coords.py. A length-L axis maps
to normalized coordinates at *cell centers*,

    u_i = (2 i + 1) / L - 1,   i = 0..L-1

so -1 and +1 lie just outside the first/last cell. Points carry (x, y)
ordering in the last axis; `size` arguments carry (height, width) ordering.
"""

from __future__ import annotations

import torch


def normalized_linspace(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Cell-center normalized coordinates of a length-`length` axis in (-1, 1)."""
    i = torch.arange(length, dtype=dtype, device=device)
    return (2.0 * i + 1.0) / length - 1.0


def normalized_to_pixel(coords: torch.Tensor, size) -> torch.Tensor:
    """Map normalized (x, y, ...) coords to pixel coords; `size` is
    (..., height, width), flipped internally so x pairs with width."""
    size = torch.as_tensor(list(size)[::-1], dtype=coords.dtype, device=coords.device)
    return 0.5 * ((coords + 1.0) * size - 1.0)


def pixel_to_normalized(coords: torch.Tensor, size) -> torch.Tensor:
    """Inverse of :func:`normalized_to_pixel`."""
    size = torch.as_tensor(list(size)[::-1], dtype=coords.dtype, device=coords.device)
    return (2.0 * coords + 1.0) / size - 1.0
