"""Gaussian uncertainty maps from contour point distributions.

Counterpart of contouring_uncertainty_tpu/utils/umap.py (Gaussian branch;
the skew map comes with the skew slice): a family of 100 contours offset
along the landmark normals by -2..2 projected sigmas, each weighted by the
normal pdf of its offset, drawn onto the grid keeping the largest weight
per pixel. Batched over leading axes (frames).
"""

from __future__ import annotations

import math

import torch

from contouring_uncertainty_torch.ops.spline import contour_spline, linspace
from contouring_uncertainty_torch.utils.projection import projected_uncertainty


def _norm_pdf(x, scale=1.0):
    return torch.exp(-0.5 * (x / scale) ** 2) / (scale * math.sqrt(2.0 * math.pi))


def _dense_contour_points(contours: torch.Tensor, n_dense: int = 1000,
                          close: bool = True) -> torch.Tensor:
    """(..., C, K, 2) landmark contours -> (..., C, P, 2) dense spline points
    (plus a straight 256-point closing segment when `close`)."""
    pts = contour_spline(contours, n=n_dense)
    if close:
        w = linspace(0.0, 1.0, 256, dtype=contours.dtype, device=contours.device)[:, None]
        seg = contours[..., -1:, :] * (1 - w) + contours[..., :1, :] * w
        pts = torch.cat([pts, seg], dim=-2)
    return pts


def _paint_points(pts: torch.Tensor, weights: torch.Tensor, shape) -> torch.Tensor:
    """(B, C, P, 2) dense points + (C,) weights -> (B, H, W) max-weight map:
    an exact scatter-amax of each contour's weight onto its rounded points."""
    height, width = shape
    b, c, p, _ = pts.shape
    xi = torch.clamp(torch.round(pts[..., 0]), 0.0, float(width - 1))
    yi = torch.clamp(torch.round(pts[..., 1]), 0.0, float(height - 1))
    idx = (yi * width + xi).to(torch.int64).reshape(b, c * p)
    src = weights.to(pts.dtype)[:, None].expand(c, p).reshape(1, c * p).expand(b, -1)
    out = torch.zeros((b, height * width), dtype=pts.dtype, device=pts.device)
    out.scatter_reduce_(1, idx, src, reduce="amax", include_self=True)
    return out.reshape(b, height, width)


def _draw_contours(contours: torch.Tensor, weights: torch.Tensor, shape,
                   n_dense: int = 1000, close: bool = True) -> torch.Tensor:
    """(B, C, K, 2) contours with per-contour weights -> (B, H, W) map."""
    return _paint_points(_dense_contour_points(contours, n_dense, close), weights, shape)


def uncertainty_map(mu: torch.Tensor, cov: torch.Tensor, shape=(256, 256),
                    close: bool = True, steps: int = 100) -> torch.Tensor:
    """Gaussian uncertainty maps: mu (B, K, 2), cov (B, K, 2, 2) -> (B, H, W)."""
    u, v = projected_uncertainty(mu, cov)
    offsets = linspace(-2.0, 2.0, steps, dtype=mu.dtype, device=mu.device)
    # contours[b, s, k] = mu[b, k] + v[b, k] * u[b, k] * offsets[s]
    contours = mu[:, None] + v[:, None] * (u[:, None, :] * offsets[None, :, None])[..., None]
    return _draw_contours(contours, _norm_pdf(offsets), shape, close=close)
