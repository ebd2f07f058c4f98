"""Bivariate skew-normal: logpdf, nll, analytic mode, marginals, sampling.

Counterpart of contouring_uncertainty_tpu/distributions/skew_normal.py,
batched over leading axes. The density is

    f(x) = 2 phi2(x; mu, Sigma) Phi(alpha^T Sigma^{-1/2} (x - mu)),

the skew direction `alpha` acting on whitened coordinates; every matrix
power is the closed-form 2x2 one of linalg.py.

Sampling, as in the JAX package: `rvs` samples the reference's law
2 phi2(x; mu, Sigma) Phi(alpha^T (x - mu)) (its augmented covariance uses
delta = Sigma alpha / sqrt(1 + alpha^T Sigma alpha), without the whitening
of `logpdf`), which the PSM sampling statistics depend on; `rvs_consistent`
samples the law `logpdf` describes. Both are kept as they are.

Random draws take a `torch.Generator` (drawn on its device, then moved);
each sampler is a transform of its standard draws (`rvs_from_draws`,
`rvs_consistent_from_draws`, `rvs_product_from_draws`), so the same draws
give the JAX package's samples.
"""

from __future__ import annotations

import math

import torch

from contouring_uncertainty_torch.distributions import normal as bvn
from contouring_uncertainty_torch.distributions.linalg import (
    chol2x2,
    cov2corr,
    mat2_vec,
    rotate_alpha,
    rotate_cov,
    sym_matrix_pow,
)
from contouring_uncertainty_torch.rng import Generators, draw_uniform

_LOG2 = math.log(2.0)
_SQRT2 = math.sqrt(2.0)


def _affine(x, mu, cov, alpha):
    """alpha^T Sigma^{-1/2} (x - mu), broadcast over leading axes."""
    white = mat2_vec(sym_matrix_pow(cov, -0.5), x - mu)
    return (alpha * white).sum(-1)


def unit_normal_logcdf(z: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """log(Phi(z) + eps): the reference's clipped form, which bounds the
    NLL's tail term at log(eps); kept for loss parity."""
    cdf = 0.5 * (1.0 + torch.erf(z / _SQRT2))
    return torch.log(cdf + eps)


def logpdf(x, mu, cov, alpha):
    """Log density, with log_ndtr for the Phi term."""
    return _LOG2 + bvn.logpdf(x, mu, cov) + torch.special.log_ndtr(_affine(x, mu, cov, alpha))


def pdf(x, mu, cov, alpha):
    return torch.exp(logpdf(x, mu, cov, alpha))


def nll(y, mu, cov, alpha):
    """Training NLL 0.5 log|S| + 0.5 maha - log(Phi + 1e-7); returns
    (loss, logdet, maha, term3), each (...,)."""
    _, logdet, maha = bvn.nll(y, mu, cov)
    term3 = unit_normal_logcdf(_affine(y, mu, cov, alpha))
    return 0.5 * logdet + 0.5 * maha - term3, logdet, maha, term3


# --- Azzalini univariate helpers -------------------------------------------------

def delta(alpha):
    return alpha / torch.sqrt(1.0 + alpha * alpha)


def skewness(alpha):
    """Pearson skewness gamma_1 of the univariate SN with shape alpha."""
    d = delta(alpha)
    num = torch.pow(d * math.sqrt(2.0 / math.pi), 3)
    den = torch.pow(1.0 - 2.0 * d * d / math.pi, 1.5)
    return (4.0 - math.pi) / 2.0 * num / den


def m0(alpha):
    """Approximate standardized mode of the univariate SN (Azzalini)."""
    mu_z = math.sqrt(2.0 / math.pi) * delta(alpha)
    sigma_z = torch.sqrt(1.0 - mu_z * mu_z)
    return (mu_z - skewness(alpha) * sigma_z / 2.0
            - torch.sign(alpha) / 2.0 * torch.exp(-2.0 * math.pi / alpha.abs()))


def univariate_mode(mu, sigma, alpha):
    return mu + sigma * m0(alpha)


def mode(mu, cov, alpha):
    """Approximate analytic mode of the bivariate SN:
    mu + (m0(a*) / a*) std * (corr @ alpha), a* = sqrt(alpha^T corr alpha)."""
    corr, std = cov2corr(cov)
    corr_alpha = mat2_vec(corr, alpha)
    alpha_star = torch.sqrt(torch.clamp((alpha * corr_alpha).sum(-1), min=1e-12))
    scale = m0(alpha_star) / alpha_star
    return mu + scale[..., None] * std * corr_alpha


def marginal(mu, cov, alpha, axis: int, angle=0.0):
    """Marginal (mean, var, alpha) along `axis` after rotating by -angle,
    with the reference's y flip of alpha before the rotation (the image's y
    axis points down)."""
    angle = torch.as_tensor(angle, dtype=cov.dtype, device=cov.device)
    cov = rotate_cov(cov, -angle)
    alpha = alpha * torch.tensor([1.0, -1.0], dtype=alpha.dtype, device=alpha.device)
    alpha = rotate_alpha(alpha, -angle)

    corr, _ = cov2corr(cov)
    not_axis = 1 - axis
    corr_11 = corr[..., axis, axis]
    corr_22 = corr[..., not_axis, not_axis]
    corr_12 = corr[..., 0, 1]
    alpha_1, alpha_2 = alpha[..., axis], alpha[..., not_axis]
    corr_22_1 = corr_22 - corr_12 * corr_12 / corr_11
    alpha_1_2 = (alpha_1 + corr_12 * alpha_2 / corr_11) / torch.sqrt(
        1.0 + alpha_2 * corr_22_1 * alpha_2)
    return mu[..., axis], cov[..., axis, axis], alpha_1_2


# --- sampling ------------------------------------------------------------------------

def _batch(*pairs):
    return torch.broadcast_shapes(*(t.shape[:t.dim() - n] for t, n in pairs))


def _uniform(generator: Generators, shape, like: torch.Tensor) -> torch.Tensor:
    return draw_uniform(generator, shape, like.dtype, like.device)


def _reference_delta(cov, alpha):
    cov_alpha = mat2_vec(cov, alpha)
    a_cov_a = (alpha * cov_alpha).sum(-1)
    return cov_alpha / torch.sqrt(1.0 + a_cov_a)[..., None]


def _consistent_delta(cov, alpha):
    # In whitened coordinates z ~ SN(0, I, alpha): delta_z = alpha / sqrt(1 + |alpha|^2).
    dz = alpha / torch.sqrt(1.0 + (alpha * alpha).sum(-1))[..., None]
    return mat2_vec(sym_matrix_pow(cov, 0.5), dz)


def _rvs_from_delta(x0, z, mu, cov, delta_vec):
    """The augmented-covariance sign-flip transform: x0 (*shape, *batch) and
    z (*shape, *batch, 2) standard normals; x1 = delta x0 + L z has
    cross-covariance delta with x0, and x = mu +- x1 by the sign of x0."""
    l_block = chol2x2(cov - delta_vec[..., :, None] * delta_vec[..., None, :])
    x1 = delta_vec * x0[..., None] + mat2_vec(l_block, z)
    return mu + torch.where(x0[..., None] <= 0, -x1, x1)


def rvs_from_draws(x0, z, mu, cov, alpha):
    """`rvs` given its standard draws x0 (*shape, *batch), z (*shape, *batch, 2)."""
    return _rvs_from_delta(x0, z, mu, cov, _reference_delta(cov, alpha))


def rvs_consistent_from_draws(x0, z, mu, cov, alpha):
    """`rvs_consistent` given its standard draws, as `rvs_from_draws`."""
    return _rvs_from_delta(x0, z, mu, cov, _consistent_delta(cov, alpha))


def _sign_flip_draws(generator, mu, cov, alpha, shape):
    batch = _batch((mu, 1), (cov, 2), (alpha, 1))
    x0 = bvn.standard_normal(generator, (*shape, *batch), mu)
    z = bvn.standard_normal(generator, (*shape, *batch, 2), mu)
    return x0, z


def rvs(generator: Generators, mu, cov, alpha, shape=()) -> torch.Tensor:
    """Reference-parity sampler of 2 phi2(x; mu, cov) Phi(alpha^T (x - mu))
    (see the module docstring). Returns (*shape, *batch, 2)."""
    return rvs_from_draws(*_sign_flip_draws(generator, mu, cov, alpha, shape), mu, cov, alpha)


def rvs_consistent(generator: Generators, mu, cov, alpha, shape=()):
    """Sampler of the law `logpdf` describes (alpha on whitened coordinates)."""
    return rvs_consistent_from_draws(*_sign_flip_draws(generator, mu, cov, alpha, shape),
                                     mu, cov, alpha)


def rvs_product_from_draws(v, z, mu_f, cov_f, w, mu_ref):
    """`rvs_product` given its draws: v (*shape, *batch) uniform on [0, 1),
    z (*shape, *batch, 2) standard normal.

    With L = chol(cov_f), c = L^T w, s = |c|, tau = w^T (mu_f - mu_ref):
    t is the standard normal truncated to (-inf, tau / sqrt(1 + s^2)] by
    inverse CDF (log space; the uniform's product with Phi floored at the
    f32 tiny before ndtri), u1 | t ~ N(rho t, 1 - rho^2) with
    rho = -s / sqrt(1 + s^2) along e = c / s, the orthogonal component
    standard normal, and x = mu_f + L u."""
    tiny = torch.finfo(mu_f.dtype).tiny
    l = chol2x2(cov_f)
    c0 = l[..., 0, 0] * w[..., 0] + l[..., 1, 0] * w[..., 1]  # c = L^T w
    c1 = l[..., 1, 1] * w[..., 1]
    s = torch.sqrt(c0 * c0 + c1 * c1)
    tau = (w * (mu_f - mu_ref)).sum(-1)
    denom = torch.sqrt(1.0 + s * s)
    rho = -s / denom

    log_p = torch.log(torch.clamp(v, min=tiny)) + torch.special.log_ndtr(tau / denom)
    t = torch.special.ndtri(torch.clamp(torch.exp(log_p), min=tiny))
    u1 = rho * t + z[..., 0] / denom  # sqrt(1 - rho^2) = 1 / denom

    safe = s > 1e-20
    s_div = torch.where(safe, s, torch.ones_like(s))
    e0 = torch.where(safe, c0 / s_div, torch.ones_like(s))
    e1 = torch.where(safe, c1 / s_div, torch.zeros_like(s))
    ux = e0 * u1 - e1 * z[..., 1]  # u = e u1 + e_perp z2
    uy = e1 * u1 + e0 * z[..., 1]
    return mu_f + mat2_vec(l, torch.stack([ux, uy], dim=-1))


def rvs_product(generator: Generators, mu_f, cov_f, w, mu_ref,
                shape=()) -> torch.Tensor:
    """Exact draw from the normalized product phi2(x; mu_f, cov_f) *
    Phi(w^T (x - mu_ref)), an extended skew-normal: the law the grid-product
    PSM sampler targets, with the two Gaussian factors merged into
    (mu_f, cov_f) and w = Sigma_p^{-1/2} alpha the whitened skew direction.
    Returns (*shape, *batch, 2)."""
    batch = _batch((mu_f, 1), (cov_f, 2), (w, 1), (mu_ref, 1))
    v = _uniform(generator, (*shape, *batch), mu_f)
    z = bvn.standard_normal(generator, (*shape, *batch, 2), mu_f)
    return rvs_product_from_draws(v, z, mu_f, cov_f, w, mu_ref)
