"""Bivariate normal distribution and closed-form 2x2 linear algebra."""

from contouring_uncertainty_torch.distributions import normal as bvn
from contouring_uncertainty_torch.distributions.linalg import rotate_cov, sym_matrix_pow
