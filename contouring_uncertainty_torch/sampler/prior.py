"""PCA shape priors and the posterior-shape-model math.

Counterpart of contouring_uncertainty_tpu/sampler/prior.py: a PCA over
flattened training contours (2K-dim), the per-prediction re-fit as one
rank-1 column d appended to a fixed factor of the train covariance, and the
masked conditional (posterior shape model) distribution by Sherman-Morrison
over a static base inverse computed once on the host in f64.

The prior's arrays are float32 tensors; `.npz` files are compatible with the
JAX package in both directions (same keys, same arrays).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class ShapePrior(NamedTuple):
    """Static prior data (float32 tensors)."""

    mean_shape: torch.Tensor  # (P,) PCA mean of training shapes (transformed space)
    train_mean: torch.Tensor  # (P,) scaler mean
    train_scale: torch.Tensor  # (P,) scaler scale
    x_train_mean: torch.Tensor  # (P,) mean of X_train (transformed)
    cov0: torch.Tensor  # (P, P) centered covariance of X_train (transformed)
    q: torch.Tensor  # (P, P) default Q = U sqrt(D) around x_train_mean

    @property
    def dim(self) -> int:
        return self.mean_shape.shape[0]

    def to(self, device) -> "ShapePrior":
        return ShapePrior(*(t.to(device) for t in self))


def transform(prior: ShapePrior, s: torch.Tensor) -> torch.Tensor:
    """Scaler transform (s - mean) / scale over the flattened last two axes."""
    shape = s.shape
    flat = (s.flatten(-2) - prior.train_mean) / prior.train_scale
    return flat.reshape(shape)


def inverse_transform(prior: ShapePrior, s: torch.Tensor) -> torch.Tensor:
    shape = s.shape
    flat = s.flatten(-2) * prior.train_scale + prior.train_mean
    return flat.reshape(shape)


def _q_from_cov(cov: np.ndarray) -> np.ndarray:
    """Q = U diag(sqrt(|lambda|)) with eigenvalues sorted descending (host, f64)."""
    vals, vecs = np.linalg.eigh(cov)
    vals = np.abs(vals)[::-1]
    vecs = vecs[:, ::-1]
    return vecs * np.sqrt(vals)[None, :]


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def fit_shape_prior(contours: np.ndarray, with_std: bool = False) -> ShapePrior:
    """Fit a prior from training contours (N, K, 2) (reference psm.py:453-554)."""
    x = np.asarray(contours).reshape(len(contours), -1).astype(np.float64)
    mean = x.mean(0)
    scale = x.std(0) if with_std else np.ones_like(mean)
    xt = (x - mean) / scale
    x_mean = xt.mean(0)
    diff = xt - x_mean
    cov0 = diff.T @ diff / len(xt)
    return ShapePrior(
        mean_shape=_f32(x_mean), train_mean=_f32(mean), train_scale=_f32(scale),
        x_train_mean=_f32(x_mean), cov0=_f32(cov0), q=_f32(_q_from_cov(cov0)),
    )


def save_prior(path: Path, prior: ShapePrior, fit_digest: Optional[str] = None):
    """Write the `.npz` prior; `fit_digest`, when given, is stored beside the
    arrays (a key the loaders of both packages ignore)."""
    extra = {} if fit_digest is None else {"fit_digest": np.array(fit_digest)}
    np.savez(path, **extra, **{k: v.detach().cpu().numpy() for k, v in prior._asdict().items()})


def load_prior(path: Path) -> ShapePrior:
    """Load the `.npz` prior format (shared with the JAX package)."""
    data = np.load(Path(path))
    return ShapePrior(**{k: torch.as_tensor(data[k]) for k in ShapePrior._fields})


def cov_factor(prior: ShapePrior, floor: float = 1e-7) -> np.ndarray:
    """Full-rank factor F0 with F0 F0^T = cov0 (host f64 eigh with a
    trace-scaled eigenvalue floor: cov0 is stored f32 and may be exactly
    rank-deficient). Returned as float32 numpy, like the JAX factor."""
    c0 = prior.cov0.detach().cpu().numpy().astype(np.float64)
    p = c0.shape[0]
    tr = max(float(np.trace(c0)) / p, 1.0)
    vals, vecs = np.linalg.eigh(c0)
    return (vecs * np.sqrt(np.maximum(vals, floor * tr))).astype(np.float32)


class PosteriorOperator(NamedTuple):
    """Static per-(mask, sigma2) precompute for posterior_shape_model_sm,
    built once on the host in f64 and stored as f32 tensors."""

    g_mask: torch.Tensor  # (P,) observation mask M (diag)
    k0: torch.Tensor  # inv(sigma2 I + (M F0)(M F0)^T)
    mc0: torch.Tensor  # M C0
    h0: torch.Tensor  # K0 (M C0)
    c0: torch.Tensor  # F0 F0^T

    def to(self, device) -> "PosteriorOperator":
        return PosteriorOperator(*(t.to(device) for t in self))


def posterior_operator(f0, g_mask, sigma2: float) -> PosteriorOperator:
    """Host-side f64 precompute of the static part of the masked-conditional
    solve for a fixed factor f0 and observation mask: S0 = sigma2 I +
    (M F0)(M F0)^T is inverted once here, and the per-prediction refit
    column enters by Sherman-Morrison (posterior_shape_model_sm)."""
    f0 = np.asarray(f0, np.float64)
    m = np.asarray(g_mask, np.float64)
    p = f0.shape[0]
    c0 = f0 @ f0.T
    fg = f0 * m[:, None]
    s0 = float(sigma2) * np.eye(p) + fg @ fg.T
    k0 = np.linalg.inv(s0)
    mc0 = c0 * m[:, None]
    h0 = k0 @ mc0
    return PosteriorOperator(g_mask=_f32(m), k0=_f32(k0), mc0=_f32(mc0),
                             h0=_f32(h0), c0=_f32(c0))


def refit_d(prior: ShapePrior, pred_flat_t: torch.Tensor) -> torch.Tensor:
    """The per-prediction refit column d with C = Cov0 + d d^T."""
    return prior.x_train_mean - pred_flat_t


def rows_times(rows: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """rows (B, S, P) @ mat ((P, Q) or (B, P, Q)) -> (B, S, Q), each
    output the sum of its P products over the last axis of a (B, S, Q, P)
    tensor. A matmul's kernel, and with it the rounding of a row, may
    change with S; this does not, so a rank that computes its share of the
    S samples per prediction gets one process's bits for them."""
    return (rows.unsqueeze(-2) * mat.transpose(-1, -2).unsqueeze(-3)).sum(-1)


def posterior_shape_model_sm(
    s_g_t: torch.Tensor,
    mu_t: torch.Tensor,
    d: Optional[torch.Tensor],
    op: PosteriorOperator,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked conditional shape distribution via Sherman-Morrison on `op`.

    Batched: s_g_t (B, S, P) observed shapes (S samples per prediction),
    mu_t (B, P), d (B, P) or None. Returns mu_c (B, S, P), cov_c (B, P, P):

        S     = S0 + u u^T,  u = M d
        S^-1  = K0 - (K0 u)(K0 u)^T / (1 + u^T K0 u)
        mu_c  = mu + (M C)^T S^-1 (s_g - mu)_g,   M C = M C0 + u d^T
        cov_c = C - (M C)^T S^-1 (M C),           C = C0 + d d^T

    The (P, P) work is per prediction; per sample only the matvec remains
    (`rows_times`, whose rounding does not depend on S).
    cov_c is accurate at the level sigmas, not at the tiny fill sigma (the
    samplers read only mu_c from the fill step)."""
    resid = (s_g_t - mu_t[:, None]) * op.g_mask  # (B, S, P)
    if d is None:
        mu_c = mu_t[:, None] + rows_times(resid, op.h0)
        cov_c = (op.c0 - op.mc0.T @ op.h0).expand(mu_t.shape[0], -1, -1)
        return mu_c, cov_c
    u = op.g_mask * d  # (B, P)
    # K0 u row by row: a (B, P) @ (P, P) product rounds differently as B
    # changes, which would make a batch of views differ from each view alone.
    v = (op.k0 * u[:, None, :]).sum(-1)
    beta = 1.0 + (u * v).sum(-1)
    sinv = op.k0 - v[:, :, None] * v[:, None, :] / beta[:, None, None]
    mc = op.mc0 + u[:, :, None] * d[:, None, :]
    half = sinv @ mc  # S^-1 (M C)
    mu_c = mu_t[:, None] + rows_times(resid, half)
    cov_c = op.c0 + d[:, :, None] * d[:, None, :] - mc.transpose(-1, -2) @ half
    return mu_c, cov_c


def diag_blocks_2x2(cov: torch.Tensor) -> torch.Tensor:
    """Per-point 2x2 diagonal blocks (..., K, 2, 2) of a (..., 2K, 2K) covariance."""
    p = cov.shape[-1]
    idx = torch.arange(p // 2, device=cov.device) * 2
    b00 = cov[..., idx, idx]
    b01 = cov[..., idx, idx + 1]
    b10 = cov[..., idx + 1, idx]
    b11 = cov[..., idx + 1, idx + 1]
    row0 = torch.stack([b00, b01], dim=-1)
    row1 = torch.stack([b10, b11], dim=-1)
    return torch.stack([row0, row1], dim=-2)
