"""Posterior-shape-model contour sampler (Gaussian branch), batched.

Counterpart of contouring_uncertainty_tpu/sampler/psm.py: coarse-to-fine
sampling of anatomically-plausible contours. The initial landmarks are
drawn from the predicted per-point Gaussians; each later level conditions on
everything sampled so far through the posterior shape model (prior.py,
Sherman-Morrison over static f64 base inverses), fuses that with the
prediction by a Gaussian product and draws the level's points; the
remaining points are filled from the posterior mean.

The JAX package vmaps one sample at a time; here the whole population is a
written-out batch: B predictions (frames x epistemic samples) x S samples.
Random draws come from explicit generators: one, or one per view when
the leading axis of the predictions holds V views (rng.py).

In the latency and composed modes (predict.py) a rank samples only its
share of each prediction's T_a samples: n is its share and each view's
generator is cut to its rows of every draw (`rng.RowBlock` on the draws'
sample axis, axis 1 of (B, n, ...)). Its samples are then bitwise one
process's: every per-sample step is elementwise, or, in the posterior
shape model, a last-axis sum whose rounding does not change with n
(`prior.rows_times`, not a matmul); the per-prediction operators (the
refit column, the Sherman-Morrison terms) are computed whole on every
rank. No part of the chain runs whole. The skew and sequence samplers
(psm_skew.py, sequence.py) split the same way.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from contouring_uncertainty_torch.device import DeviceLike, resolve_device
from contouring_uncertainty_torch.distributions import bvn
from contouring_uncertainty_torch.distributions.linalg import (
    inv2x2, mat2_mat, mat2_vec, sym_matrix_pow)
from contouring_uncertainty_torch.rng import Generators
from contouring_uncertainty_torch.sampler import prior as prior_lib
from contouring_uncertainty_torch.sampler.prior import ShapePrior


def get_points_order(nb_points: int = 21, nb_initial_points: int = 3,
                     levels: Optional[int] = None) -> Tuple[List[int], List[List[int]]]:
    """Coarse-to-fine point ordering by recursive bisection
    (reference psm.py:43-71, rounding toward the base)."""
    initial_points = np.round(np.linspace(0, nb_points - 1, nb_initial_points)).astype(int).tolist()
    levels = levels or int(math.log(nb_points, 2))
    all_points: List[int] = list(initial_points)
    point_order: List[List[int]] = []
    for _ in range(levels):
        level_points = []
        for j in range(len(all_points) - 1):
            if all_points[j] + 1 != all_points[j + 1]:
                point = (all_points[j] + all_points[j + 1]) / 2
                point = math.ceil(point) if point > nb_points / 2 else math.floor(point)
                level_points.append(int(point))
        if not level_points:
            break
        all_points.extend(level_points)
        all_points.sort()
        point_order.append(level_points)
    return initial_points, point_order


def merge_priors(mu1, cov1, mu2, cov2):
    """Gaussian product fusion per point (reference psm.py:423-440).

    Sigma_f = S1 (S1+S2)^-1 S2 ;  mu_f = S1 (S1+S2)^-1 mu2 + S2 (S1+S2)^-1 mu1,
    all (..., 2, 2) / (..., 2) with closed-form 2x2 inverses."""
    inv_sum = inv2x2(cov1 + cov2)
    cov_f = mat2_mat(mat2_mat(cov1, inv_sum), cov2)
    mu_f = mat2_vec(mat2_mat(cov1, inv_sum), mu2) + mat2_vec(mat2_mat(cov2, inv_sum), mu1)
    return mu_f, cov_f


class PosteriorShapeModelSampler:
    """Batched PSM sampler. Construct once per prior; call per prediction batch."""

    def __init__(self, prior: ShapePrior, levels: int = 3,
                 sigmas: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0),
                 fill_sigma: float = 1e-3, device: DeviceLike = None):
        device = resolve_device(device)
        self.prior = prior.to(device)
        self.k = prior.dim // 2
        self.initial_points, self.points_order = get_points_order(self.k, levels=levels)
        self.sigmas = sigmas
        self.fill_sigma = fill_sigma

        # Static masks: coords observed *before* each level, per-level point sets.
        sampled = list(self.initial_points)
        level_masks = []
        self._level_points = []  # (K,) bool point masks per level
        for points in self.points_order:
            mask = np.zeros(prior.dim, np.float32)
            for p in sampled:
                mask[2 * p:2 * p + 2] = 1.0
            level_masks.append(mask)
            self._level_points.append(self._point_mask(points, device))
            sampled.extend(points)
        final_mask = np.zeros(prior.dim, np.float32)
        for p in sampled:
            final_mask[2 * p:2 * p + 2] = 1.0
        self._level_masks = level_masks  # (P,) f32 numpy coordinate masks
        self._sampled_all = self._point_mask(sampled, device)
        self._initial = self._point_mask(self.initial_points, device)
        # Fixed full-rank factor of cov0 and the static Sherman-Morrison
        # operators per level (+ fill), precomputed on the host in f64.
        f0 = prior_lib.cov_factor(prior)
        self._ops = [prior_lib.posterior_operator(f0, m, s).to(device)
                     for m, s in zip(level_masks, self.sigmas)]
        self._op_final = prior_lib.posterior_operator(f0, final_mask, fill_sigma).to(device)

    def _point_mask(self, points, device) -> torch.Tensor:
        mask = torch.zeros(self.k, dtype=torch.bool)
        mask[list(points)] = True
        return mask.to(device)

    def _posterior_points(self, contour, op, mu_t, d):
        """Posterior (mu_c (B, S, K, 2), cov_c (B, K, 2, 2)) in pixel space
        given the currently sampled contours (B, S, K, 2); unsampled entries
        are masked out by the level's observation mask."""
        s_g_t = prior_lib.transform(self.prior, contour).flatten(-2)
        mu_c_t, cov_c_t = prior_lib.posterior_shape_model_sm(s_g_t, mu_t, d, op)
        mu_c = prior_lib.inverse_transform(self.prior, mu_c_t.unflatten(-1, (self.k, 2)))
        # Pixel-space covariance: diag(scale) cov diag(scale).
        scale = self.prior.train_scale
        cov_c_t = cov_c_t * scale[None, :] * scale[:, None]
        cov_c = prior_lib.diag_blocks_2x2(cov_c_t)
        # PD floor on the 2x2 blocks: the difference C - CMS^-1MC cancels in
        # f32 for predictions far from the shape space; a slightly
        # indefinite block would NaN the draws. No-op for healthy posteriors.
        cov_c = sym_matrix_pow(cov_c, 1.0, eps=1e-6)
        return mu_c, cov_c

    def sample_batch(self, generator: Generators, mu: torch.Tensor,
                     cov: torch.Tensor, n: int = 1) -> torch.Tensor:
        """mu (..., K, 2), cov (..., K, 2, 2) -> (..., n, K, 2) contours.
        With V generators, mu's leading axis holds the V views.
        (A skew task's alpha goes to sampler/psm_skew.py.)"""
        lead = mu.shape[:-2]
        mu_p = mu.reshape(-1, self.k, 2)  # (B, K, 2)
        cov_p = cov.reshape(-1, self.k, 2, 2)
        b = mu_p.shape[0]
        mu_t = prior_lib.transform(self.prior, mu_p).flatten(-2)  # (B, P)
        d = prior_lib.refit_d(self.prior, mu_t)

        # Initial points: independent draws from the predicted distributions
        # (covariances broadcast over the n samples; one normal per sample).
        mu_pb, cov_pb = mu_p[:, None], cov_p[:, None]
        s0 = bvn.rvs(generator, mu_pb.expand(b, n, self.k, 2), cov_pb)
        contour = torch.where(self._initial[:, None], s0, torch.zeros_like(s0))

        for op, points in zip(self._ops, self._level_points):
            mu_c, cov_c = self._posterior_points(contour, op, mu_t, d)
            mu_f, cov_f = merge_priors(mu_pb, cov_pb, mu_c, cov_c[:, None])
            s = bvn.rvs(generator, mu_f, cov_f)
            contour = torch.where(points[:, None], s, contour)

        # Fill the remaining points from the posterior mean (sigma2 -> 0).
        mu_c, _ = self._posterior_points(contour, self._op_final, mu_t, d)
        contour = torch.where(self._sampled_all[:, None], contour, mu_c)
        return contour.reshape(*lead, n, self.k, 2)
