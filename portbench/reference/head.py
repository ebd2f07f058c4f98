"""Plain DSNT head: the spatial softmax of each heatmap, its mean and
covariance in pixels, and the per-point Gaussian NLL of training.

Coordinates are cell centres, u_i = (2i + 1) / L - 1 in normalised units,
pixel = 0.5 * ((u + 1) * L - 1); second moments scale by (W / 2)^2.
Variances are floored at 1e-2 px^2 and the correlation is held below
0.999 (the published positive-definiteness guard).
"""

from __future__ import annotations

import torch


def gaussians(logits: torch.Tensor, dtype: torch.dtype):
    """(..., H, W) logits -> mu (..., 2) and cov (..., 2, 2) in pixels,
    computed in `dtype` from the softmax over all H*W pixels."""
    h, w = logits.shape[-2:]
    p = torch.softmax(logits.to(dtype).flatten(-2), dim=-1).unflatten(-1, (h, w))
    xs = (2.0 * torch.arange(w, dtype=dtype, device=p.device) + 1.0) / w - 1.0
    ys = (2.0 * torch.arange(h, dtype=dtype, device=p.device) + 1.0) / h - 1.0
    col, row = p.sum(-2), p.sum(-1)
    ex, ey = (col * xs).sum(-1), (row * ys).sum(-1)
    vx = (col * (xs - ex[..., None]) ** 2).sum(-1)
    vy = (row * (ys - ey[..., None]) ** 2).sum(-1)
    cxy = ((p * (xs - ex[..., None, None])).sum(-1) * (ys - ey[..., None])).sum(-1)
    mu = torch.stack([0.5 * ((ex + 1.0) * w - 1.0), 0.5 * ((ey + 1.0) * h - 1.0)], dim=-1)
    scale = (w / 2.0) ** 2
    vx, vy = torch.clamp(vx * scale, min=1e-2), torch.clamp(vy * scale, min=1e-2)
    bound = 0.999 * torch.sqrt(vx * vy)
    cxy = torch.minimum(torch.maximum(cxy * scale, -bound), bound)
    cov = torch.stack([torch.stack([vx, cxy], -1), torch.stack([cxy, vy], -1)], -2)
    return mu, cov


def gaussian_nll(mu, cov, y):
    """log|Sigma| + (mu - y)^T Sigma^-1 (mu - y) per point."""
    diff = (mu - y).unsqueeze(-1)
    maha = (diff.transpose(-1, -2) @ torch.linalg.solve(cov, diff))[..., 0, 0]
    return torch.logdet(cov) + maha
