"""Contour -> mask rasterization: even-odd scanline fill, batched over masks.

Counterpart of contouring_uncertainty_tpu/ops/rasterize.py:

1. densify each contour (spline or straight segments) into a closed
   polygon with a static number of edges;
2. per image row keep the 16 smallest crossing abscissae of the row's
   pixel-centre line (ops/select_kernel.py: the CUDA kernel on the
   GPU, its plain top-k version on the CPU);
3. a pixel is inside iff an odd number of kept crossings lie to its left
   (none in a row whose crossings are NaN, as in the JAX package);
4. the rounded dense vertices are marked as boundary pixels (what the
   reference's scipy binary_fill_holes also keeps); a vertex with a NaN
   coordinate marks none.

The JAX package's `CUTPU_EXACT_TOPK` switch has no counterpart: on a CUDA
tensor the selection always goes through the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from contouring_uncertainty_torch.ops.select_kernel import min_k_crossings
from contouring_uncertainty_torch.ops.spline import contour_spline


def _densify_linear(points: torch.Tensor, n_per_edge: int) -> torch.Tensor:
    """(..., K, 2) landmarks -> (..., K*n_per_edge, 2) closed polyline."""
    nxt = torch.roll(points, -1, dims=-2)
    w = torch.arange(n_per_edge, dtype=points.dtype, device=points.device) / n_per_edge
    dense = (points[..., :, None, :] * (1.0 - w)[:, None]
             + nxt[..., :, None, :] * w[:, None])
    return dense.reshape(*points.shape[:-2], -1, 2)


def polygon_fill(dense: torch.Tensor, height: int, width: int,
                 include_boundary: bool = True) -> torch.Tensor:
    """Even-odd fill of closed polygons given densified vertices (..., E, 2)
    in (x, y). Returns float32 (..., height, width) {0,1} masks."""
    flat = dense.reshape(-1, *dense.shape[-2:])
    xs = min_k_crossings(flat, height)  # (M, H, 16) ascending
    mask = fill_from_crossings(xs, flat, width, include_boundary)
    return mask.reshape(*dense.shape[:-2], height, width)


def fill_from_crossings(xs: torch.Tensor, dense: torch.Tensor, width: int,
                        include_boundary: bool = True) -> torch.Tensor:
    """Even-odd masks (M, H, W) from the sorted per-row crossings xs
    (M, H, k) of the polygons dense (M, E, 2)."""
    m, height, k = xs.shape
    cols = torch.arange(width, dtype=dense.dtype, device=dense.device)
    # counts[y, x] = #{j : x >= xs[y, j]}: a sorted search of each pixel
    # column in the row's crossing list.
    counts = torch.searchsorted(xs.reshape(m * height, k),
                                cols.expand(m * height, width).contiguous(),
                                right=True, out_int32=True)
    # An all-NaN row (a NaN candidate, see ops/select_kernel.py) counts no
    # crossing: cols >= NaN is false.
    odd = (counts & 1).reshape(m, height, width) * ~torch.isnan(xs[..., :1])
    mask = odd.to(torch.float32).reshape(m, height * width)
    if include_boundary:
        xi = torch.clamp(torch.round(dense[..., 0]), 0.0, float(width - 1))
        yi = torch.clamp(torch.round(dense[..., 1]), 0.0, float(height - 1))
        flat = yi * width + xi
        painted = ~torch.isnan(flat)
        idx = torch.where(painted, flat, 0.0).to(torch.int64)
        # max with 1 where painted and 0 elsewhere: order-independent
        mask.scatter_reduce_(1, idx, painted.to(torch.float32), reduce="amax")
    return mask.reshape(m, height, width)


def rasterize_spline(points: torch.Tensor, height: int, width: int,
                     n_dense: int = 1024, include_boundary: bool = True) -> torch.Tensor:
    """Spline-interpolated filled contour masks (reference `reconstruction`).

    The polygon is the dense open spline through the landmarks; the implicit
    edge from the last dense vertex back to the first is the straight
    'closing line' the reference draws explicitly. points (..., K, 2)."""
    dense = contour_spline(points, n=n_dense, close=False)
    return polygon_fill(dense, height, width, include_boundary)


def rasterize_linear(points: torch.Tensor, height: int, width: int,
                     n_per_edge: int = 8, include_boundary: bool = True) -> torch.Tensor:
    """Straight-segment filled contour masks (reference `linear_reconstruction`)."""
    dense = _densify_linear(points, n_per_edge)
    return polygon_fill(dense, height, width, include_boundary)


def rasterize_batch(points: torch.Tensor, height: int, width: int,
                    linear: bool = False, n_dense: int = 1024) -> torch.Tensor:
    """Rasterize over arbitrary leading axes. points (..., K, 2) -> (..., H, W)."""
    if linear:
        return rasterize_linear(points, height, width)
    return rasterize_spline(points, height, width, n_dense=n_dense)


def zigzag_contours(n_contours: int = 64, seed: int = 0) -> np.ndarray:
    """The degenerate closed contours of the JAX `approx_parity_check`
    (ops/rasterize.py:157-196), drawn identically: 21 landmarks on a noisy
    circle with the most crossings per scanline. (n_contours, 21, 2) f32."""
    rng = np.random.default_rng(seed)
    k = 21
    theta = np.linspace(0.0, 2.0 * np.pi, k, endpoint=False)
    radius = rng.uniform(20.0, 100.0, size=(n_contours, k))
    cx = rng.uniform(90.0, 160.0, size=(n_contours, 1))
    cy = rng.uniform(90.0, 160.0, size=(n_contours, 1))
    pts = np.stack(
        [cx + radius * np.cos(theta), cy + radius * np.sin(theta)], axis=-1
    ).astype(np.float32)
    pts += rng.normal(scale=6.0, size=pts.shape).astype(np.float32)
    return pts


EDGE_CASE_SIZE = 64  # image height and width of `selection_edge_cases`


def nan_circle(n_points: int = 64, radius: float = 8.0, centre: float = 16.0,
               nan_vertex=5) -> np.ndarray:
    """A closed polygon of n_points on a circle about (centre, centre), with
    both coordinates of vertex `nan_vertex` set to NaN (none if None):
    (n_points, 2) f32 (x, y). The rows above the vertex's neighbours come
    out of the crossing selection all NaN."""
    angle = np.arange(n_points) * (2.0 * np.pi / n_points)
    pts = np.stack([centre + radius * np.cos(angle), centre + radius * np.sin(angle)], -1)
    pts = pts.astype(np.float32)
    if nan_vertex is not None:
        pts[nan_vertex] = np.nan
    return pts


def _comb(n_teeth: int) -> list:
    """A comb of n_teeth spikes from y = 50.5 up to y = 3.3 over x in
    [2, 62]: 2 * n_teeth crossings on each row from 4 to 50."""
    pts = []
    for i in range(n_teeth):
        a = 2.0 + i * 60.0 / n_teeth
        pts += [(a, 50.5), (a + 0.3 * 60.0 / n_teeth, 3.3)]
    return pts + [(62.0, 50.5), (62.0, 58.5), (2.0, 58.5)]


def selection_edge_cases(n_vertices: int = 256) -> dict:
    """Closed polygons that make the crossing selection hard, on a
    64 x 64 image: name -> (M, n_vertices, 2) f32 (x, y), each polygon
    padded to n_vertices by repeating its last vertex (zero-length edges).

    - integer_rows: vertices exactly on integer rows, so that two edges
      meet on a row (tied crossings), and a monotone pass through a vertex
      on a row (one crossing);
    - horizontal: edges lying on a row (integer and half-integer), and an
      edge whose rise (2e-13) is under the 1e-12 division guard but
      straddles row 0;
    - outside: vertices above, below, left and right of the image, edges
      spanning it, polygons wholly outside, coordinates of 1e6;
    - many_crossings: combs with 24 and 40 crossings per row (more than the
      16 kept, and more than a row's bucket in the CUDA kernel holds);
    - non_finite: NaN and infinite vertex coordinates, whose rows come out
      all NaN (`nan_circle`'s, with a NaN x or y alone, an infinite x or
      y, a long edge to a vertex with a NaN x, and a polygon of NaN
      vertices only, which crosses no row).
    """
    nan = float("nan")
    inf = float("inf")

    def circle_with(i, xy):
        pts = [tuple(p) for p in nan_circle(n_points=32, nan_vertex=None)]
        pts[i] = xy
        return pts

    cases = {
        "integer_rows": [
            [(32, 4), (56, 32), (32, 60), (8, 32)],
            [(4, 10), (8, 20), (12, 10), (16, 20), (20, 10), (24, 20), (28, 10),
             (32, 20), (36, 10), (40, 20), (44, 10), (60, 10), (60, 50), (40, 40),
             (30, 50), (20, 40), (4, 50)],
            [(10, 5), (10, 5), (30, 25), (30, 25), (50, 45), (20, 45), (20, 45)],
            [(5, 5), (25, 15), (45, 25), (45, 40), (25, 30), (5, 20)],
        ],
        "horizontal": [
            [(10, 12), (50, 12), (50, 40), (10, 40)],
            [(5, 5), (20, 5), (20, 15), (35, 15), (35, 25), (50, 25), (50, 55), (5, 55)],
            [(8.25, 30.5), (40.75, 30.5), (40.75, 44.5), (30, 44.5), (30, 60), (8.25, 60)],
            [(5, -1e-13), (40, 1e-13), (40, 20), (5, 20)],
        ],
        "outside": [
            [(-30, -50), (200, 30), (10, 150)],
            [(10, -40), (50, -40), (30, -5)],
            [(10, 70), (50, 70), (30, 95.5)],
            [(-40, 5), (-5, 30), (-40, 55)],
            [(70, 5), (100, 30), (70, 55)],
            [(-1e6, -1e6), (1e6, -1e6), (1e6, 1e6), (-1e6, 1e6)],
            [(-20, 32), (32, -20), (84, 32), (32, 84)],
        ],
        "many_crossings": [_comb(12), _comb(20)],
        "non_finite": [
            [tuple(p) for p in nan_circle()],
            circle_with(3, (nan, 20.0)),
            circle_with(9, (22.0, nan)),
            circle_with(20, (10.0, inf)),
            circle_with(27, (-inf, 12.0)),
            circle_with(14, (inf, -inf)),
            [(5.0, 5.0), (50.0, 5.0), (nan, 60.0), (5.0, 40.0)],
            [(nan, nan)] * 6,
        ],
    }
    out = {}
    for name, polys in cases.items():
        arr = np.empty((len(polys), n_vertices, 2), np.float32)
        for i, poly in enumerate(polys):
            p = np.asarray(poly, np.float32)
            arr[i, :len(p)] = p
            arr[i, len(p):] = p[-1]
        out[name] = arr
    return out
