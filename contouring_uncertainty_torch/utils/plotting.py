"""Plotting helpers: confidence ellipses and skewed-normal glyphs.

Counterpart of contouring_uncertainty_tpu/utils/plotting.py, drawn with the
same matplotlib calls. matplotlib is imported inside `confidence_ellipse`
only (`plot_skewed_normals` draws on the axes it is given): the machine
with the card has none, and the port's modules import without it. The
skew-normal density is evaluated with torch on the CPU, in f32 as JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from contouring_uncertainty_torch.distributions import skew_normal as bsn


def confidence_ellipse(x, y, cov, ax, n_std: float = 2.0, facecolor="none",
                       edgecolor="red", **kwargs):
    """Draw the n-sigma ellipse of a 2x2 covariance centered at (x, y)."""
    from matplotlib.patches import Ellipse
    import matplotlib.transforms as transforms

    cov = np.asarray(cov, float)
    pearson = cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1])
    pearson = np.clip(pearson, -0.9999, 0.9999)
    rx = np.sqrt(1 + pearson)
    ry = np.sqrt(1 - pearson)
    ellipse = Ellipse((0, 0), width=rx * 2, height=ry * 2,
                      facecolor=facecolor, edgecolor=edgecolor, **kwargs)
    transf = (
        transforms.Affine2D()
        .rotate_deg(45)
        .scale(np.sqrt(cov[0, 0]) * n_std, np.sqrt(cov[1, 1]) * n_std)
        .translate(float(x), float(y))
    )
    ellipse.set_transform(transf + ax.transData)
    return ax.add_patch(ellipse)


def plot_skewed_normals(ax, mu, cov, alpha, n_levels: int = 2, cmap="plasma",
                        flip_y: bool = True, grid_half: float = 25.0,
                        resolution: int = 101):
    """Contour the skew-normal pdf of each landmark around its mean."""
    mu = np.asarray(mu, float)
    cov = np.asarray(cov, float)
    alpha = np.asarray(alpha, float)
    if flip_y:
        alpha = alpha * np.array([1.0, -1.0])
    g = np.linspace(-grid_half, grid_half, resolution)
    for k in range(mu.shape[0]):
        X, Y = np.meshgrid(g + mu[k, 0], g + mu[k, 1])
        pts = np.stack([X.ravel(), Y.ravel()], -1)
        pdf = bsn.pdf(*(torch.as_tensor(a, dtype=torch.float32)
                        for a in (pts, mu[k], cov[k], alpha[k]))).numpy().reshape(X.shape)
        levels = np.linspace(pdf.max() * 0.1, pdf.max() * 0.9, n_levels)
        ax.contour(X, Y, pdf, levels=levels, cmap=cmap, linewidths=0.8)
