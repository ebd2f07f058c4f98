"""Projection of per-point uncertainty onto contour normals.

Counterpart of contouring_uncertainty_tpu/utils/projection.py: the spline
tangent at each landmark defines a normal direction; the 1D marginal of the
point's (skew-)normal along it is the projected uncertainty. Batched over
leading axes: mu (..., K, 2), cov (..., K, 2, 2), alpha (..., K, 2).
"""

from __future__ import annotations

from typing import Optional

import torch

from contouring_uncertainty_torch.distributions import bsn, bvn
from contouring_uncertainty_torch.distributions.linalg import eigh2x2
from contouring_uncertainty_torch.ops.spline import contour_tangents


def projection_vectors(mu: torch.Tensor) -> torch.Tensor:
    """Per-landmark projection direction v = (t_y, -t_x) (..., K, 2)."""
    t = contour_tangents(mu)
    return torch.stack([t[..., 1], -t[..., 0]], dim=-1)


def projected_uncertainty(mu: torch.Tensor, cov: torch.Tensor,
                          alpha: Optional[torch.Tensor] = None, return_all: bool = True):
    """(u (..., K), v (..., K, 2)): projected sigma and direction per
    landmark, and the projected skew alpha_proj (..., K) when `alpha` is
    given: (u, v, alpha_proj).

    With `return_all=False` the base/apex points (0, K//2, K-1) report the
    sum of sqrt-eigenvalues instead of the projected marginal."""
    v = projection_vectors(mu)
    angle = torch.atan2(v[..., 1], v[..., 0])
    if alpha is not None:
        _, var, alpha_proj = bsn.marginal(mu, cov, alpha, axis=0, angle=angle)
    else:
        _, var = bvn.marginal(mu, cov, axis=0, angle=angle)
    u = torch.sqrt(var)
    if not return_all:
        k = mu.shape[-2]
        vals, _ = eigh2x2(cov)
        eig_u = torch.sqrt(torch.clamp(vals, min=0.0)).sum(-1)
        special = torch.zeros(k, dtype=torch.bool, device=mu.device)
        special[[0, k // 2, k - 1]] = True
        u = torch.where(special, eig_u, u)
    if alpha is not None:
        return u, v, alpha_proj
    return u, v


def projected_uncertainty_value(mu: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Scalar instant uncertainty: sum of projected sigmas, (...,)."""
    u, _ = projected_uncertainty(mu, cov, return_all=False)
    return u.sum(-1)
