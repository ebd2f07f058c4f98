"""DSNT (differentiable spatial-to-numerical transform) heads in PyTorch.

Counterpart of contouring_uncertainty_tpu/ops/dsnt.py. Raw moments of the
spatial softmax are converted to pixel-space Gaussians (mu, Sigma) with the
reference's scaling (`pixel = 0.5*((c+1)*size - 1)`, second moments times
(size/2)^2) and the shared positive-definiteness guard.

`logits_to_pixel_gaussians` dispatches on the tensor's device: on the GPU
every call goes through the row-layout moment kernel K2 (ops/dsnt_kernel.py,
csrc/dsnt_moments.cu), on the CPU through its plain f32 separable version.
On both it carries gradients to the logits (the moments' autograd Function),
so the training loss (`gaussian_nll`, `euclidean_error`) backpropagates
through it.
"""

from __future__ import annotations

from typing import Optional

import torch

from contouring_uncertainty_torch.ops.coords import normalized_linspace, normalized_to_pixel
from contouring_uncertainty_torch.ops.dsnt_kernel import dsnt_raw_moments


def flat_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the trailing two (spatial) axes. Input (..., H, W)."""
    shape = logits.shape
    flat = logits.reshape(*shape[:-2], shape[-2] * shape[-1])
    return torch.softmax(flat, dim=-1).reshape(shape)


def dsnt_moments(probs: torch.Tensor, compute_skew: bool = False):
    """First/second (and optionally third central) moments of spatial pmfs.

    probs (..., K, H, W) normalized heatmaps -> mean (..., K, 2), var
    (..., K, 2), cov (..., K) [, skew (..., K, 2)], in normalized units.
    Accumulated in f32 as elementwise products and sums (no matmul)."""
    height, width = probs.shape[-2:]
    p = probs.to(torch.float32)
    xs = normalized_linspace(width, device=p.device)
    ys = normalized_linspace(height, device=p.device)
    col = p.sum(-2)  # (..., W)
    row = p.sum(-1)  # (..., H)
    ex = (col * xs).sum(-1)
    ey = (row * ys).sum(-1)
    exx = (col * (xs * xs)).sum(-1)
    eyy = (row * (ys * ys)).sum(-1)
    exy = ((p * xs).sum(-1) * ys).sum(-1)
    mean = torch.stack([ex, ey], dim=-1)
    var = torch.stack([exx - ex * ex, eyy - ey * ey], dim=-1)
    cov = exy - ex * ey
    if not compute_skew:
        return mean, var, cov
    exxx = (col * (xs * xs * xs)).sum(-1)
    eyyy = (row * (ys * ys * ys)).sum(-1)
    # Third central moment: E[u^3] - 3 mu E[u^2] + 2 mu^3.
    skew = torch.stack([
        exxx - 3.0 * ex * exx + 2.0 * ex ** 3,
        eyyy - 3.0 * ey * eyy + 2.0 * ey ** 3,
    ], dim=-1)
    return mean, var, cov, skew


def build_cov_matrix(var: torch.Tensor, cov_xy: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 2, 2) covariance matrices from per-axis variances + cross term."""
    row0 = torch.stack([var[..., 0], cov_xy], dim=-1)
    row1 = torch.stack([cov_xy, var[..., 1]], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _pixel_gaussians(mean, var, cov, height: int, width: int, use_covar: bool):
    """Normalized moments -> pixel-space (mu, Sigma) with the PD guard:
    variances floored at 1e-2 px^2 and |corr| clamped below 0.999 (the
    reference loss NaNs when a heatmap collapses to a delta)."""
    mu = normalized_to_pixel(mean, (height, width))
    scale = (width / 2.0) ** 2
    pixel_var = torch.clamp(var * scale, min=1e-2)
    pixel_cov = cov * scale if use_covar else torch.zeros_like(cov)
    max_cov = 0.999 * torch.sqrt(pixel_var[..., 0] * pixel_var[..., 1])
    pixel_cov = torch.minimum(torch.maximum(pixel_cov, -max_cov), max_cov)
    return mu, build_cov_matrix(pixel_var, pixel_cov)


def heatmaps_to_pixel_gaussians(logits: torch.Tensor, use_covar: bool = True):
    """Full DSNT head: logits (..., K, H, W) -> (probs, mu (..., K, 2),
    sigma (..., K, 2, 2)), materializing the softmax."""
    height, width = logits.shape[-2:]
    probs = flat_softmax(logits)
    mean, var, cov = dsnt_moments(probs)
    mu, sigma = _pixel_gaussians(mean, var, cov, height, width, use_covar)
    return probs, mu, sigma


def logits_to_pixel_gaussians(logits: torch.Tensor, use_covar: bool = True,
                              whole_rows: Optional[int] = None):
    """Lean DSNT head used on the serving path: logits (..., K, H, W) ->
    (mu (..., K, 2), sigma (..., K, 2, 2)) without materializing the softmax.

    The (rows, H*W) view of the logits goes through `dsnt_raw_moments`: the
    CUDA row kernel for CUDA tensors (bf16, f16 or f32, one read of the
    logits), the plain f32 separable reduction for CPU tensors. With
    `whole_rows` (the heatmaps of the whole batch, when `logits` are one
    rank's rows of it) the kernel splits each heatmap as it would for the
    whole batch."""
    *lead, height, width = logits.shape
    raw = dsnt_raw_moments(logits.reshape(-1, height * width), height, width, whole_rows)
    raw = raw[:, :6].reshape(*lead, 6)
    return raw6_to_pixel_gaussians(raw, height, width, use_covar)


def raw6_to_pixel_gaussians(raw: torch.Tensor, height: int, width: int,
                            use_covar: bool = True):
    """Normalized raw moments [1, x, y, x^2, y^2, xy] (..., 6) -> pixel-space
    (mu, Sigma) with the shared PD guard."""
    ex, ey = raw[..., 1], raw[..., 2]
    var = torch.stack([raw[..., 3] - ex * ex, raw[..., 4] - ey * ey], dim=-1)
    cov = raw[..., 5] - ex * ey
    return _pixel_gaussians(torch.stack([ex, ey], dim=-1), var, cov,
                            height, width, use_covar)


def gaussian_nll(mu: torch.Tensor, sigma: torch.Tensor, y: torch.Tensor,
                 log_penalty_weight: float = 1.0, mse_weight: float = 1.0):
    """Per-point bivariate Gaussian NLL: w1*log|Sigma| + w2*(mu-y)^T Sigma^-1 (mu-y),
    with the closed-form 2x2 adjugate. Returns (loss, logdet, maha), each (...,)."""
    a = sigma[..., 0, 0]
    b = sigma[..., 0, 1]
    d = sigma[..., 1, 1]
    det = a * d - b * b
    diff = mu - y
    dx, dy = diff[..., 0], diff[..., 1]
    maha = (d * dx * dx - 2.0 * b * dx * dy + a * dy * dy) / det
    logdet = torch.log(det)
    loss = log_penalty_weight * logdet + mse_weight * maha
    return loss, logdet, maha


def euclidean_error(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-point Euclidean distance over the last axis."""
    d = pred - target
    return torch.sqrt((d * d).sum(-1))
