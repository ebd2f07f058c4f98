"""Skew posterior-shape-model sampler, batched.

Counterpart of contouring_uncertainty_tpu/sampler/psm_skew.py: the initial
landmarks are drawn from the predicted bivariate skew-normals (alpha
y-flipped once more here, as in the JAX package); then per level each skew
point (`skew_indices`, a static gather) is drawn from the product of its
predicted skew-normal pdf and the PSM posterior Gaussian, the other points
from the Gaussian product fusion; the remaining points fill from the
posterior mean.

Two methods for the skew-product draw:

- `esn` (default): the product is an extended skew-normal (the two Gaussian
  factors merged, the Phi factor left as a tilt), drawn exactly in closed
  form by `bsn.rvs_product`;
- `grid`: the reference's lattice categorical over a `grid_window`^2 window
  of the pixel lattice (the global grid's integer cell centres), centred on
  each point's fusion mean, its pitch widened per point so the window spans
  at least 6 fused sigmas. The logits are evaluated separably: the x and y
  lattice coordinates stay (..., W) vectors and only the (..., W, W) logits
  are formed, never a (..., W^2, 2) grid of points. The categorical is a
  Gumbel argmax with noise from the generator.

The whole population is one batch: B predictions (frames x epistemic
samples) x S samples, as in sampler/psm.py.
"""

from __future__ import annotations

import math
import warnings
from typing import List, Optional

import numpy as np
import torch

from contouring_uncertainty_torch.distributions import bsn, bvn, linalg
from contouring_uncertainty_torch.rng import Generators, draw_uniform
from contouring_uncertainty_torch.sampler import prior as prior_lib
from contouring_uncertainty_torch.sampler.prior import ShapePrior
from contouring_uncertainty_torch.sampler.psm import PosteriorShapeModelSampler, merge_priors

_LOG_2PI = math.log(2.0 * math.pi)


def _lattice_gauss_logpdf(gx, gy, mu, cov):
    """Bivariate normal log density on the lattice gx (..., W) x gy (..., W)
    of each point: mu (..., 2), cov (..., 2, 2) -> (..., W, W), x first."""
    a, b, d = cov[..., 0, 0, None, None], cov[..., 0, 1, None, None], cov[..., 1, 1, None, None]
    det = a * d - b * b
    dx = (gx - mu[..., 0, None])[..., :, None]
    dy = (gy - mu[..., 1, None])[..., None, :]
    maha = (d * dx * dx - 2.0 * b * dx * dy + a * dy * dy) / det
    return -_LOG_2PI - 0.5 * torch.log(det) - 0.5 * maha


def _lattice_skew_logpdf(gx, gy, mu, cov, alpha):
    """bsn.logpdf on the lattice, as `_lattice_gauss_logpdf`: the whitened
    skew term alpha^T S^{-1/2} (g - mu) = w^T (g - mu), w = S^{-1/2} alpha."""
    w = linalg.mat2_vec(linalg.sym_matrix_pow(cov, -0.5), alpha)
    affine = ((w[..., 0, None] * (gx - mu[..., 0, None]))[..., :, None]
              + (w[..., 1, None] * (gy - mu[..., 1, None]))[..., None, :])
    return (math.log(2.0) + _lattice_gauss_logpdf(gx, gy, mu, cov)
            + torch.special.log_ndtr(affine))


class SkewPosteriorShapeModelSampler(PosteriorShapeModelSampler):
    def __init__(self, prior: ShapePrior, levels: int = 3,
                 skew_indices: Optional[List[int]] = None, grid_size: int = 256,
                 image_extent: float = 255.0, grid_window: Optional[int] = 64,
                 method: str = "esn", **kwargs):
        if method not in ("esn", "grid"):
            raise ValueError(f"method must be 'esn' or 'grid', got {method!r}")
        super().__init__(prior, levels=levels, **kwargs)
        self.method = method
        skew_indices = list(range(self.k)) if skew_indices is None else list(skew_indices)
        device = self.prior.mean_shape.device
        self._skew_idx = torch.as_tensor(np.unique(np.asarray(skew_indices, np.int64)),
                                         device=device)
        self._extent = float(image_extent)
        self._step = image_extent / (grid_size - 1)  # grid cell pitch
        # Window cells from the fixed-prior posterior bound (grid_window=None
        # sizes it; an explicit window under 6 sigmas warns for 'grid'); at
        # sample time `_point_steps` widens the pitch of a point whose fused
        # covariance the static bound cannot see.
        max_std_px = self._posterior_std_bound_px()
        needed = int(np.ceil(6.0 * max_std_px / self._step)) + 1
        if grid_window is None:
            w = min(max(needed, 32), int(grid_size))
        else:
            w = min(int(grid_window), int(grid_size))
            if w < min(needed, int(grid_size)) and method == "grid":
                warnings.warn(
                    f"SkewPSM grid_window={w} covers less than 6 prior sigmas "
                    f"({max_std_px:.1f} px max marginal prior std needs ~{needed} cells): "
                    "grid-product samples may truncate tail mass. Pass grid_window=None "
                    "to auto-size, or grid_window=grid_size for the exact full-grid draw.",
                    stacklevel=2)
        self.window = w
        self._cells = torch.arange(w, dtype=torch.float32, device=device)

    def _posterior_std_bound_px(self) -> float:
        """Max per-coordinate posterior std (pixels) over the sampling
        levels with the default prior Q, on the host in f64:
        cov_c = sigma_l^2 Q (Q_g^T Q_g + sigma_l^2 I)^-1 Q^T."""
        q = self.prior.q.detach().cpu().double().numpy()
        scale = self.prior.train_scale.detach().cpu().double().numpy()
        p = q.shape[0]
        worst = 0.0
        for mask, sigma2 in zip(self._level_masks, self.sigmas):
            q_g = q * np.asarray(mask, np.float64)[:, None]
            a = q_g.T @ q_g + float(sigma2) * np.eye(p)
            cov = float(sigma2) * q @ np.linalg.solve(a, q.T)
            std_px = np.sqrt(np.maximum(np.diagonal(cov), 0.0)) * scale
            worst = max(worst, float(std_px.max()))
        return worst

    def _point_steps(self, cov_fuse: torch.Tensor) -> torch.Tensor:
        """(..., 1) per-point lattice pitch: the global pitch, widened to
        6 sigma / (W - 1) where the fused sigma (sqrt of the larger diagonal
        entry) needs more span than the window gives."""
        sig = torch.sqrt(torch.clamp(torch.maximum(cov_fuse[..., 0, 0], cov_fuse[..., 1, 1]),
                                     min=0.0))
        return torch.clamp(6.0 * sig / (self.window - 1), min=self._step)[..., None]

    def _window_offsets(self, centers: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
        """(..., 2) window origins on the global lattice, centred on the
        fusion means and clipped inside the image."""
        half = (self.window - 1) / 2.0 * steps
        hi = torch.clamp(self._extent - (self.window - 1) * steps, min=0.0)
        snapped = torch.round((centers - half) / self._step) * self._step
        return torch.clamp(snapped, min=torch.zeros_like(hi), max=hi)

    def _grid_draw(self, generator, offs, steps, mu_p, cov_p, alpha_f, mu_c, cov_c):
        """One categorical draw per point over its window's lattice of the
        skew-pdf x posterior-pdf product: offs (..., 2), steps (..., 1) ->
        (..., 2) lattice points."""
        gx = offs[..., 0, None] + self._cells * steps  # (..., W)
        gy = offs[..., 1, None] + self._cells * steps
        logits = (_lattice_skew_logpdf(gx, gy, mu_p, cov_p, alpha_f)
                  + _lattice_gauss_logpdf(gx, gy, mu_c, cov_c)).flatten(-2)
        u = draw_uniform(generator, logits.shape, logits.dtype, logits.device)
        tiny = torch.finfo(logits.dtype).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        idx = torch.argmax(logits + gumbel, dim=-1)
        sub = torch.stack([torch.div(idx, self.window, rounding_mode="floor"),
                           idx % self.window], dim=-1)
        return offs + sub.to(offs.dtype) * steps

    def sample_batch(self, generator: Generators, mu: torch.Tensor,
                     cov: torch.Tensor, alpha: Optional[torch.Tensor] = None,
                     n: int = 1) -> torch.Tensor:
        """mu (..., K, 2), cov (..., K, 2, 2), alpha (..., K, 2) -> (..., n, K, 2)."""
        if alpha is None:
            raise ValueError("the skew PSM sampler needs alpha")
        lead = mu.shape[:-2]
        flip = torch.tensor([1.0, -1.0], dtype=alpha.dtype, device=alpha.device)
        mu_p = mu.reshape(-1, self.k, 2)  # (B, K, 2)
        cov_p = cov.reshape(-1, self.k, 2, 2)
        alpha_f = alpha.reshape(-1, self.k, 2) * flip
        b = mu_p.shape[0]
        mu_t = prior_lib.transform(self.prior, mu_p).flatten(-2)  # (B, P)
        d = prior_lib.refit_d(self.prior, mu_t)
        si = self._skew_idx

        mu_pb, cov_pb, alpha_fb = mu_p[:, None], cov_p[:, None], alpha_f[:, None]
        s0 = bsn.rvs(generator, mu_pb.expand(b, n, self.k, 2), cov_pb, alpha_fb)
        contour = torch.where(self._initial[:, None], s0, torch.zeros_like(s0))
        if self.method == "esn":
            # whitened skew direction Sigma^{-1/2} alpha (bsn.logpdf's)
            w = linalg.mat2_vec(linalg.sym_matrix_pow(cov_pb[:, :, si], -0.5),
                                alpha_fb[:, :, si])

        for op, points in zip(self._ops, self._level_points):
            mu_c, cov_c = self._posterior_points(contour, op, mu_t, d)
            cov_c = cov_c[:, None]
            mu_fuse, cov_fuse = merge_priors(mu_pb, cov_pb, mu_c, cov_c)
            s_gauss = bvn.rvs(generator, mu_fuse, cov_fuse)  # (B, n, K, 2)
            if self.method == "esn":
                s_skew = bsn.rvs_product(generator, mu_fuse[:, :, si], cov_fuse[:, :, si], w,
                                         mu_pb[:, :, si])
            else:
                steps = self._point_steps(cov_fuse[:, :, si])  # (B, 1, S, 1)
                offs = self._window_offsets(mu_fuse[:, :, si], steps)  # (B, n, S, 2)
                s_skew = self._grid_draw(generator, offs, steps, mu_pb[:, :, si],
                                         cov_pb[:, :, si], alpha_fb[:, :, si],
                                         mu_c[:, :, si], cov_c[:, :, si])
            s = s_gauss.index_copy(2, si, s_skew)
            contour = torch.where(points[:, None], s, contour)

        mu_c, _ = self._posterior_points(contour, self._op_final, mu_t, d)
        contour = torch.where(self._sampled_all[:, None], contour, mu_c)
        return contour.reshape(*lead, n, self.k, 2)
