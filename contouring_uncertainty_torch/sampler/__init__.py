"""Contour sampler: the Gaussian posterior-shape-model sampler and its prior."""

from contouring_uncertainty_torch.sampler.prior import ShapePrior, fit_shape_prior
from contouring_uncertainty_torch.sampler.psm import PosteriorShapeModelSampler
