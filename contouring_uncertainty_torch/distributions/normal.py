"""Bivariate normal: logpdf, nll, marginals and sampling, batched over leading axes.

Counterpart of contouring_uncertainty_tpu/distributions/normal.py. Sampling
takes explicit generators (rng.py: one, or one per leading view block of
the draw); the standard normals are drawn on the generator's device and
moved to `mu`'s, so a CPU generator gives the same draws on every device.
"""

from __future__ import annotations

import math

import torch

from contouring_uncertainty_torch.distributions.linalg import chol2x2, mat2_vec, rotate_cov
from contouring_uncertainty_torch.rng import Generators, draw_normal

_LOG_2PI = math.log(2.0 * math.pi)


def logpdf(x: torch.Tensor, mu: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Log density of N(mu, cov) at x. Shapes broadcast; last axis is the 2-vector."""
    a = cov[..., 0, 0]
    b = cov[..., 0, 1]
    d = cov[..., 1, 1]
    det = a * d - b * b
    diff = x - mu
    dx, dy = diff[..., 0], diff[..., 1]
    maha = (d * dx * dx - 2.0 * b * dx * dy + a * dy * dy) / det
    return -_LOG_2PI - 0.5 * torch.log(det) - 0.5 * maha


def nll(y: torch.Tensor, mu: torch.Tensor, cov: torch.Tensor):
    """Unnormalized NLL log|cov| + maha; returns (nll, logdet, maha), each (...,)."""
    a = cov[..., 0, 0]
    b = cov[..., 0, 1]
    d = cov[..., 1, 1]
    det = a * d - b * b
    diff = mu - y
    dx, dy = diff[..., 0], diff[..., 1]
    maha = (d * dx * dx - 2.0 * b * dx * dy + a * dy * dy) / det
    logdet = torch.log(det)
    return logdet + maha, logdet, maha


def marginal(mu: torch.Tensor, cov: torch.Tensor, axis: int, angle=0.0):
    """Marginal (mean, variance) along `axis` after rotating cov by -angle."""
    angle = torch.as_tensor(angle, dtype=cov.dtype, device=cov.device)
    cov = rotate_cov(cov, -angle)
    return mu[..., axis], cov[..., axis, axis]


def standard_normal(generator: Generators, shape, like: torch.Tensor) -> torch.Tensor:
    """Standard normals of `shape` in `like`'s dtype, drawn on the generator's
    device (the CPU without one) and moved to `like`'s device."""
    return draw_normal(generator, shape, like.dtype, like.device)


def rvs(generator: Generators, mu: torch.Tensor, cov: torch.Tensor,
        shape=()) -> torch.Tensor:
    """Sample from N(mu, cov); returns shape (*shape, *mu.shape) (with
    several generators, the draw's first axis holds the views)."""
    chol = chol2x2(cov)
    z = standard_normal(generator, (*shape, *mu.shape), mu)
    return mu + mat2_vec(chol, z)
