"""Sigma statistics: average covariance against average landmark distance.

Counterpart of `sigma_stats` in contouring_uncertainty_tpu/results/extras.py.
The module's other processors (`skewness`, `plotting`, `prediction_writer`)
are not ported: results/__init__.py `NOT_PORTED` names where each waits.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

from contouring_uncertainty_torch.results import register


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
