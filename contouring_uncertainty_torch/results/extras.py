"""Skewness diagnostics and sigma statistics.

Counterpart of `skewness` and `sigma_stats` in
contouring_uncertainty_tpu/results/extras.py, in numpy and scipy on the
host as there. `skewness` writes the numbers without the scatter figure
(results/__init__.py `FIGURES_NOT_PORTED`); the module's other processors
(`plotting`, `prediction_writer`) are not ported: `NOT_PORTED` names where
each waits.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

from contouring_uncertainty_torch.results import register


@register("skewness")
def skewness(results: List, out_dir: Path) -> dict:
    """Per-landmark error clouds and the average alpha: `skewness.npy`
    ({"errors": (frames, K, 2) contour - mu, "average_skew": (frames, K, 2)
    alpha}), and the mean over landmarks of the errors' sample skewness in
    x and y and the mean alpha norm."""
    from scipy.stats import skew as sp_skew

    point_errors, alphas = [], []
    for res in results:
        if res.mu is None or res.contour is None:
            continue
        for i in range(res.img.shape[0]):
            point_errors.append(res.contour[i] - res.mu[i])
            if res.alpha is not None:
                alphas.append(res.alpha[i])
    if not point_errors:
        return {}
    point_errors = np.stack(point_errors)
    np.save(out_dir / "skewness.npy",
            {"errors": point_errors,
             "average_skew": np.stack(alphas) if alphas else np.zeros(0)},
            allow_pickle=True)
    out = {
        "error_skew_x": float(np.mean(sp_skew(point_errors[..., 0], axis=0))),
        "error_skew_y": float(np.mean(sp_skew(point_errors[..., 1], axis=0))),
    }
    if alphas:
        out["mean_alpha_norm"] = float(np.linalg.norm(np.stack(alphas), axis=-1).mean())
    return out


@register("sigma_stats")
def sigma_stats(results: List, out_dir: Path) -> dict:
    """Average covariance vs average distance per landmark."""
    sigmas, dists = [], []
    for res in results:
        if res.mu is None or res.contour is None or res.cov is None:
            continue
        dists.append(np.linalg.norm(res.mu - res.contour, axis=-1))
        sigmas.append(res.cov)
    if not sigmas:
        return {}
    sigmas = np.concatenate(sigmas).mean(0)  # (K, 2, 2)
    dists = np.concatenate(dists).mean(0)  # (K,)
    det = np.maximum(np.linalg.det(sigmas), 0) ** 0.25
    np.save(out_dir / "sigma_stats.npy", {"avg_cov": sigmas, "avg_dist": dists},
            allow_pickle=True)
    corr = float(np.corrcoef(det, dists)[0, 1]) if len(det) > 2 else np.nan
    return {"avg_sigma_det": float(det.mean()), "avg_distance": float(dists.mean()),
            "corr_det_distance": corr}
