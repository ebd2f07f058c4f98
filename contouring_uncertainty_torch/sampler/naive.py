"""Naive sampler: independent per-point (skew-)normal draws.

Counterpart of contouring_uncertainty_tpu/sampler/naive.py: n independent
draws of every landmark from its own bivariate normal (or skew-normal,
given alpha), in one batched draw from the caller's `torch.Generator`
(rng.py); with `sample_indices`, the other landmarks stay at their mean.
The JAX sampler draws from a key: the two agree in distribution, not
value by value.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from contouring_uncertainty_torch.distributions import bsn, bvn
from contouring_uncertainty_torch.rng import Generators


class NaiveSampler:
    def __init__(self, sample_indices: Optional[Sequence[int]] = None):
        self.sample_indices = tuple(sample_indices) if sample_indices is not None else None

    def __call__(self, generator: Generators, mu: torch.Tensor, cov: torch.Tensor,
                 alpha: Optional[torch.Tensor] = None, n: int = 1) -> torch.Tensor:
        """mu (K, 2), cov (K, 2, 2), optional alpha (K, 2) -> samples (n, K, 2)."""
        if alpha is None:
            samples = bvn.rvs(generator, mu, cov, shape=(n,))
        else:
            samples = bsn.rvs(generator, mu, cov, alpha, shape=(n,))
        if self.sample_indices is not None:
            keep = torch.zeros(mu.shape[0], dtype=torch.bool, device=mu.device)
            keep[list(self.sample_indices)] = True
            samples = torch.where(keep[None, :, None], samples, mu[None])
        return samples
