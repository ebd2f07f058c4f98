"""Bivariate normal and skew-normal distributions, closed-form 2x2 linear algebra."""

from contouring_uncertainty_torch.distributions import normal as bvn
from contouring_uncertainty_torch.distributions import skew_normal as bsn
from contouring_uncertainty_torch.distributions.linalg import (
    cov2corr,
    rotate_alpha,
    rotate_cov,
    sym_matrix_pow,
)
