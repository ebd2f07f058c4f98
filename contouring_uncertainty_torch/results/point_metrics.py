"""Per-landmark metrics: X/Y/L2 errors (mu, mode, posterior) with adaptive
calibration and threshold sweeps -> data_point.npy, then the JAX
package's figures: correlation_point.png, calibration_points.png,
post_calibration_points.png, thresholds_points.png and
corr_thresholds-Error-cov_det.png.

Counterpart of contouring_uncertainty_tpu/results/point_metrics.py; the
figures are drawn after the numbers (results/__init__.py `draw_figures`).
"""

from __future__ import annotations

from collections import defaultdict
from functools import partial
from pathlib import Path
from typing import List

import numpy as np

from contouring_uncertainty_torch.results import draw_figures, register
from contouring_uncertainty_torch.results.utils import (
    _pearson,
    _plot_calibration,
    _plot_corr,
    _plot_corr_thresholds,
    _plot_thresholds,
    calibration_curves,
    compute_correlations,
    correlation_sweep,
    dataframe_to_dict,
    threshold_curves,
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
    draws = []
    if uncertainties:
        corr = compute_correlations(uncertainties, metrics)
        summary.update(dataframe_to_dict(corr, "corr-"))
        draws.append(partial(_plot_corr, corr, "Point Metrics Correlation",
                             out_dir / "correlation_point.png"))

        # Average per-landmark error vs average determinant correlation.
        if errors and determinants:
            err_k = np.stack(errors).mean(0)
            det_k = np.stack(determinants).mean(0)
            summary["avg_cov-avg_det"] = _pearson(det_k, err_k)

        for prefix, filename in (("", "calibration_points.png"),
                                 ("post_", "post_calibration_points.png")):
            results, curves = calibration_curves(
                uncertainties, metrics,
                [f"{prefix}cov_xx", f"{prefix}cov_yy", f"{prefix}cov_det",
                 f"{prefix}cov_eigval_sum"],
                [f"{prefix}X-Error", f"{prefix}Y-Error", f"{prefix}Error", f"{prefix}Error"],
                adaptive=True,
            )
            summary.update(results)
            if curves:
                draws.append(partial(_plot_calibration, curves, out_dir / filename))
        results, curves = threshold_curves(
            uncertainties, metrics,
            ["cov_xx", "cov_yy", "cov_det"],
            ["X-Error", "Y-Error", "Error"],
        )
        summary.update(results)
        if curves:
            draws.append(partial(_plot_thresholds, curves, out_dir / "thresholds_points.png"))
        results, sweep = correlation_sweep(uncertainties, metrics, "cov_det", "Error")
        summary.update(results)
        if sweep is not None:
            draws.append(partial(_plot_corr_thresholds, sweep, "cov_det", "Error", out_dir))
    return draw_figures(summary, draws)
