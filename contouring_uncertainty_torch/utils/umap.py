"""Uncertainty maps from contour point distributions, batched over frames.

Counterpart of contouring_uncertainty_tpu/utils/umap.py:

- `uncertainty_map` (Gaussian): a family of 100 contours offset along the
  landmark normals by -2..2 projected sigmas, each weighted by the normal
  pdf of its offset, drawn onto the grid keeping the largest weight per
  pixel;
- `skew_umap`: the projected mode contour, and 2L = 200 level-set contours
  of each point's projected skew-normal profile, rasterized as filled masks
  (all frames' contours in one fill, so one launch of the crossing
  selection), weighted-averaged and reduced to a per-pixel two-class
  entropy; `skew_umap_groups` does it for each structure of a
  multi-structure landmark vector, all structures in one launch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from contouring_uncertainty_torch.ops.rasterize import polygon_fill
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


def skew_level_contours(mu: torch.Tensor, cov: torch.Tensor, alpha: torch.Tensor,
                        levels: int = 100, resolution: int = 1000):
    """The projected mode (B, K, 2) and the 2L level-set contours
    (B, 2L, K, 2) with their weights (2L,) of `skew_umap`.

    Each point's skew-normal, projected on its contour normal, is evaluated
    on `resolution` steps across +-3 projected sigmas; the mode is its first
    argmax, and for each of `levels` values 1 - linspace(0, 0.95) the first
    argmin of |pdf - value| on either side of the mode gives the minus and
    plus level contours (ties go to the first index, as in JAX)."""
    u, v, alpha_proj = projected_uncertainty(mu, cov, alpha)
    p1 = mu + v * (u * 2.0)[..., None]
    p2 = mu - v * (u * 2.0)[..., None]
    inv_res = float(np.float32(1) / np.float32(resolution))

    frac = linspace(0.0, 1.0, resolution, dtype=mu.dtype, device=mu.device)
    x = (frac * 6.0 - 3.0) * u[..., None]  # (B, K, R) in [-3u, 3u]
    z = x / u[..., None]
    pdf = 2.0 * _norm_pdf(z) * torch.special.ndtr(alpha_proj[..., None] * z)
    pdf = pdf / pdf.amax(dim=-1, keepdim=True)
    mode_idx = torch.argmax(pdf, dim=-1)  # (B, K)

    def along(idx, a, b):  # grid indices (..., K) -> points on the segments b..a
        f = (idx.to(mu.dtype) * inv_res)[..., None]
        return a * f + b * (1.0 - f)

    vals = 1.0 - linspace(0.0, 0.95, levels, dtype=mu.dtype, device=mu.device)  # (L,)
    right = (torch.arange(resolution, device=mu.device) > mode_idx[..., None])[..., None, :, :]
    d = (pdf[..., None, :, :] - vals[:, None, None]).abs()  # (B, L, K, R)
    inf = torch.full((), math.inf, dtype=d.dtype, device=d.device)
    plus = torch.argmin(torch.where(right, d, inf), dim=-1)  # (B, L, K)
    minus = torch.argmin(torch.where(right, inf, d), dim=-1)
    a, b = p1[..., None, :, :], p2[..., None, :, :]
    # The 2L contour family: the minus levels reversed, then the plus levels.
    contours = torch.cat([along(minus, a, b).flip(-3), along(plus, a, b)], dim=-3)
    w_half = _norm_pdf(torch.arange(levels, dtype=mu.dtype, device=mu.device),
                       scale=levels / 2.0)
    return along(mode_idx, p1, p2), contours, torch.cat([w_half.flip(0), w_half])


def skew_umap(mu: torch.Tensor, cov: torch.Tensor, alpha: torch.Tensor, shape=(256, 256),
              levels: int = 100, resolution: int = 1000):
    """Skew uncertainty map and projected mode: mu (B, K, 2), cov
    (B, K, 2, 2), alpha (B, K, 2) -> (projected mode (B, K, 2), map (B, H, W)):
    the two-class entropy of the weighted mean of the level contours' masks
    (`skew_level_contours`), all B * 2L masks in one fill."""
    return skew_umap_groups(mu, cov, alpha, ((0, mu.shape[-2], 1),), shape, levels,
                            resolution)[0]


def skew_umap_groups(mu: torch.Tensor, cov: torch.Tensor, alpha: torch.Tensor, groups,
                     shape=(256, 256), levels: int = 100, resolution: int = 1000):
    """`skew_umap` of each (start, end, label) landmark slice of `groups`:
    a list of (projected mode (B, k, 2), map (B, H, W)), one per structure.
    The level contours of all structures are splined to 1024 vertices (as
    `rasterize_batch`) and filled in one `polygon_fill` call, so one
    crossing-selection launch for all of them."""
    parts = [skew_level_contours(mu[..., a:b, :], cov[..., a:b, :, :], alpha[..., a:b, :],
                                 levels, resolution) for a, b, _ in groups]
    dense = torch.stack([contour_spline(c, n=1024, close=False) for _, c, _ in parts])
    masks = polygon_fill(dense, shape[0], shape[1])  # (G, B, 2L, H, W)
    out = []
    for (projected_mode, _, weights), m in zip(parts, masks):
        mean_mask = (m * weights[:, None, None]).sum(-3) / weights.sum()
        entropy = -(mean_mask * torch.log(mean_mask + 1e-12)
                    + (1.0 - mean_mask) * torch.log(1.0 - mean_mask + 1e-12))
        out.append((projected_mode, entropy))
    return out
