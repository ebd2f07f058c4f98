"""Per-landmark metrics: X/Y/L2 errors (mu, mode, posterior) with adaptive
calibration and threshold sweeps -> data_point.npy.

Counterpart of contouring_uncertainty_tpu/results/point_metrics.py,
without its figures.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import List

import numpy as np

from contouring_uncertainty_torch.results import register
from contouring_uncertainty_torch.results.utils import (
    _pearson,
    calibration,
    compute_correlations,
    dataframe_to_dict,
    thresholded_correlation,
    thresholded_metrics,
)


@register("point_metrics")
def point_metrics(results: List, out_dir: Path) -> dict:
    metrics = defaultdict(list)
    uncertainties = defaultdict(list)
    errors, determinants = [], []

    for res in results:
        if res.mu is None or res.contour is None:
            continue
        for i in range(res.img.shape[0]):
            gt = res.contour[i]
            for name, pts in (("", res.mu[i]), ("mode_", res.mode[i]),
                              ("post_", res.post_mu[i] if res.post_mu is not None else None)):
                if pts is None:
                    continue
                metrics[f"{name}X-Error"].extend(np.abs(pts[:, 0] - gt[:, 0]).tolist())
                metrics[f"{name}Y-Error"].extend(np.abs(pts[:, 1] - gt[:, 1]).tolist())
                metrics[f"{name}Error"].extend(np.sqrt(((pts - gt) ** 2).sum(1)).tolist())
            errors.append(np.sqrt(((res.mu[i] - gt) ** 2).sum(1)))
            if res.point_uncertainty:
                determinants.append(np.asarray(res.point_uncertainty["cov_det"][i]))
                for key, unc in res.point_uncertainty.items():
                    uncertainties[key].extend(np.asarray(unc[i]).ravel().tolist())

    if not metrics:
        return {}

    np.save(out_dir / "data_point.npy",
            {"metrics": dict(metrics), "uncertainty": dict(uncertainties)},
            allow_pickle=True)

    summary = {k: float(np.nanmean(v)) for k, v in metrics.items()}
    if uncertainties:
        summary.update(dataframe_to_dict(compute_correlations(uncertainties, metrics), "corr-"))

        # Average per-landmark error vs average determinant correlation.
        if errors and determinants:
            err_k = np.stack(errors).mean(0)
            det_k = np.stack(determinants).mean(0)
            summary["avg_cov-avg_det"] = _pearson(det_k, err_k)

        summary.update(calibration(
            uncertainties, metrics,
            ["cov_xx", "cov_yy", "cov_det", "cov_eigval_sum"],
            ["X-Error", "Y-Error", "Error", "Error"], adaptive=True,
        ))
        summary.update(calibration(
            uncertainties, metrics,
            ["post_cov_xx", "post_cov_yy", "post_cov_det", "post_cov_eigval_sum"],
            ["post_X-Error", "post_Y-Error", "post_Error", "post_Error"], adaptive=True,
        ))
        summary.update(thresholded_metrics(
            uncertainties, metrics,
            ["cov_xx", "cov_yy", "cov_det"],
            ["X-Error", "Y-Error", "Error"],
        ))
        summary.update(thresholded_correlation(uncertainties, metrics, "cov_det", "Error"))
    return summary
