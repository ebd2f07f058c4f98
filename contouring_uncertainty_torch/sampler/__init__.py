"""Contour samplers: the Gaussian and skew posterior-shape-model samplers, their
sequence (ED <-> ES) variants and their prior."""

from contouring_uncertainty_torch.sampler.prior import ShapePrior, fit_shape_prior
from contouring_uncertainty_torch.sampler.psm import PosteriorShapeModelSampler
from contouring_uncertainty_torch.sampler.psm_skew import SkewPosteriorShapeModelSampler
from contouring_uncertainty_torch.sampler.sequence import SequencePSMSampler, SequenceSkewPSMSampler
