"""Sequence (ED <-> ES) PSM samplers: a view's two instants coupled through
a 4K-dim two-instant shape prior, batched.

Counterpart of contouring_uncertainty_tpu/sampler/sequence.py. For each
sample pair a first instant (ED or ES, a fair coin) is drawn with the
single-instant sampler from its own prediction; the sequence posterior
conditioned on that contour gives a prior for the other instant, fused with
its prediction by the Gaussian product, and the second instant is drawn
from the fused prediction with the same single-instant sampler.

- `SequencePSMSampler`: the Gaussian PSM sampler per instant and the fixed
  sequence prior (its PCA factor Q, no refit column), as the JAX package
  does after the reference's commented-out refit;
- `SequenceSkewPSMSampler`: the skew PSM sampler per instant, the sequence
  prior's floored full-rank factor and the per-prediction refit column.

The JAX package vmaps one pair at a time; here all T_e x n pairs of a view
(or of V views) are one batch: the coin flips are one draw, both
Sherman-Morrison operators (first instant ED or ES) are built once, applied
to every pair and picked per pair, and each instant is one call of the
single-instant sampler at B = pairs, n = 1 (which refits its column per
row, so each pair's fused second-instant prediction gets its own).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from contouring_uncertainty_torch.device import DeviceLike, resolve_device
from contouring_uncertainty_torch.distributions.linalg import sym_matrix_pow
from contouring_uncertainty_torch.rng import Generators, draw_uniform, on_axis
from contouring_uncertainty_torch.sampler import prior as prior_lib
from contouring_uncertainty_torch.sampler.prior import ShapePrior
from contouring_uncertainty_torch.sampler.psm import PosteriorShapeModelSampler, merge_priors
from contouring_uncertainty_torch.sampler.psm_skew import SkewPosteriorShapeModelSampler


def _instant_masks(k: int):
    """Observation masks of the 4K sequence vector: first instant ED (the
    first 2K coordinates) and first instant ES (the last 2K)."""
    m0 = np.zeros(4 * k, np.float32)
    m0[:2 * k] = 1.0
    return m0, 1.0 - m0


def _pick(first_is_0: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per pair, a where the first instant is ED, else b; first_is_0 (B, S)
    broadcast over a's and b's trailing axes."""
    flag = first_is_0.reshape(first_is_0.shape + (1,) * (a.dim() - first_is_0.dim()))
    return torch.where(flag, a, b)


class SequencePSMSampler:
    """Gaussian sequence sampler over (ED, ES) predictions."""

    def __init__(self, prior: ShapePrior, seq_prior: ShapePrior, levels: int = 3,
                 device: DeviceLike = None):
        # The fixed factor of the sequence prior's covariance: its PCA factor
        # Q (Q Q^T = cov0, the reference's Q-form posterior).
        self._setup(PosteriorShapeModelSampler(prior, levels=levels, device=device),
                    seq_prior, seq_prior.q.detach().cpu().numpy())

    def _setup(self, instant: PosteriorShapeModelSampler, seq_prior: ShapePrior, base):
        device = instant.prior.mean_shape.device
        self.instant = instant
        self.k = instant.k
        self.seq_prior = seq_prior.to(device)
        # Both observation masks' Sherman-Morrison operators, on the host in f64.
        self._seq_ops = [prior_lib.posterior_operator(base, m, 1.0).to(device)
                         for m in _instant_masks(self.k)]

    def _seq_params(self, mu: torch.Tensor):
        """(B, 2, K, 2) predictions -> the sequence prior's mean (B, 4K) and
        refit column: the fixed prior's mean shape and none (the reference
        comments the refit out)."""
        mean = self.seq_prior.mean_shape
        return mean.expand(mu.shape[0], mean.shape[0]), None

    def _sample_instant(self, generator: Generators, mu, cov, alpha):
        """One draw per pair: mu (B, S, K, 2) -> (B, S, K, 2). The
        single-instant sampler draws for the B*S pairs flattened into its
        axis 0, where a row block of the S samples lies in each of B runs
        (`rng.on_axis`)."""
        return self.instant.sample_batch(on_axis(generator, 0, mu.shape[0]), mu, cov,
                                         n=1)[..., 0, :, :]

    def _sequence_posterior(self, s_first, first_is_0, seq_mu_t, seq_d):
        """The sequence posterior given each pair's first instant:
        s_first (B, S, K, 2), first_is_0 (B, S) bool, seq_mu_t (B, 4K),
        seq_d (B, 4K) or None -> per instant mu_c (B, S, 2, K, 2) and
        cov_c (B, S, 2, K, 2, 2), the 2x2 blocks floored to PD as in the
        single-instant sampler."""
        sp = self.seq_prior
        flat = s_first.flatten(-2)
        zeros = torch.zeros_like(flat)
        s_full = _pick(first_is_0, torch.cat([flat, zeros], -1), torch.cat([zeros, flat], -1))
        s_t = (s_full - sp.train_mean) / sp.train_scale
        scale = sp.train_scale
        posts = []
        for op in self._seq_ops:
            mu_c_t, cov_c_t = prior_lib.posterior_shape_model_sm(s_t, seq_mu_t, seq_d, op)
            cov_c_t = cov_c_t * scale[None, :] * scale[:, None]
            blocks = sym_matrix_pow(prior_lib.diag_blocks_2x2(cov_c_t), 1.0, eps=1e-6)
            posts.append((mu_c_t * scale + sp.train_mean, blocks[:, None]))
        mu_c = _pick(first_is_0, posts[0][0], posts[1][0]).unflatten(-1, (2, self.k, 2))
        cov_c = _pick(first_is_0, posts[0][1], posts[1][1]).unflatten(-3, (2, self.k))
        return mu_c, cov_c

    def sample_batch(self, generator: Generators, mu: torch.Tensor, cov: torch.Tensor,
                     alpha: Optional[torch.Tensor] = None, n: int = 1) -> torch.Tensor:
        """mu (..., 2, T_e, K, 2), cov (..., 2, T_e, K, 2, 2)[, alpha
        (..., 2, T_e, K, 2)] -> (..., 2, T_e, n, K, 2): each epistemic
        forward's (ED, ES) pair sampled jointly, n pairs per forward. With V
        generators the leading axis holds the V views."""
        if mu.dim() < 4 or mu.shape[-4] != 2:
            raise ValueError(f"sequence sampling expects (ED, ES) predictions, got mu "
                             f"{tuple(mu.shape)}")
        lead, t_e, k = mu.shape[:-4], mu.shape[-3], self.k
        pairs = lambda x, tail: x.movedim(-tail - 2, -tail - 1).reshape(-1, 2, *x.shape[-tail:])
        mu_p, cov_p = pairs(mu, 2), pairs(cov, 3)  # (B, 2, K, 2), (B, 2, K, 2, 2)
        alpha_p = None if alpha is None else pairs(alpha, 2)
        first_is_0 = draw_uniform(generator, (mu_p.shape[0], n), mu.dtype, mu.device) < 0.5

        def instant(x, first):  # the prediction of each pair's first (or second) instant
            if x is None:
                return None
            a, b = x[:, None, 0], x[:, None, 1]
            return _pick(first_is_0, a, b) if first else _pick(first_is_0, b, a)

        seq_mu_t, seq_d = self._seq_params(mu_p)
        s_first = self._sample_instant(generator, instant(mu_p, True), instant(cov_p, True),
                                       instant(alpha_p, True))
        mu_c, cov_c = self._sequence_posterior(s_first, first_is_0, seq_mu_t, seq_d)
        mu_f, cov_f = merge_priors(mu_p[:, None], cov_p[:, None], mu_c, cov_c)
        second = lambda x: _pick(first_is_0, x[:, :, 1], x[:, :, 0])
        s_second = self._sample_instant(generator, second(mu_f), second(cov_f),
                                        instant(alpha_p, False))
        out = torch.stack([_pick(first_is_0, s_first, s_second),
                           _pick(first_is_0, s_second, s_first)], dim=2)  # (B, n, 2, K, 2)
        return out.reshape(*lead, t_e, n, 2, k, 2).movedim(-3, -5)


class SequenceSkewPSMSampler(SequencePSMSampler):
    """Skew sequence sampler: the skew PSM sampler per instant, and the
    sequence prior refit around each prediction."""

    def __init__(self, prior: ShapePrior, seq_prior: ShapePrior, levels: int = 3,
                 skew_indices: Optional[List[int]] = None, device: DeviceLike = None,
                 **skew_kw):
        instant = SkewPosteriorShapeModelSampler(prior, levels=levels, skew_indices=skew_indices,
                                                 device=resolve_device(device), **skew_kw)
        self._setup(instant, seq_prior, prior_lib.cov_factor(seq_prior))

    def _seq_params(self, mu: torch.Tensor):
        """The prediction pair in the sequence prior's space (B, 4K) and its
        refit column (the reference refits the sequence PCA around it)."""
        sp = self.seq_prior
        seq_pred_t = (mu.reshape(mu.shape[0], -1) - sp.train_mean) / sp.train_scale
        return seq_pred_t, prior_lib.refit_d(sp, seq_pred_t)

    def _sample_instant(self, generator: Generators, mu, cov, alpha):
        return self.instant.sample_batch(on_axis(generator, 0, mu.shape[0]), mu, cov,
                                         alpha=alpha, n=1)[..., 0, :, :]
