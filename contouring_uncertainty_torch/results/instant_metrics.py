"""Instant-level metrics: Dice, landmark L2, uncertainty correlations ->
instant_metrics.csv and data_instant.npy.

Counterpart of contouring_uncertainty_tpu/results/instant_metrics.py,
without the correlation figure.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import List

import numpy as np

from contouring_uncertainty_torch.results import register
from contouring_uncertainty_torch.results.utils import (
    Table,
    compute_correlations,
    dataframe_to_dict,
    dice,
)

# ImageQuality ordinal encoding for correlation analyses (CAMUS attrs).
_QUALITY_SCORE = {"Good": 2.0, "Medium": 1.0, "Poor": 0.0}


@register("instant_metrics")
def instant_metrics(results: List, out_dir: Path) -> dict:
    metrics = defaultdict(list)
    uncertainties = defaultdict(list)
    ids = []
    qualities = []
    for res in results:
        for i in range(res.img.shape[0]):
            ids.append(f"{res.id}-{i}")
            qualities.append(getattr(res, "image_quality", None) or "Unknown")
            if res.gt is not None:
                for k, v in dice(res.pred[i], res.gt[i], res.labels, all_classes=True).items():
                    metrics[k].append(v)
            if res.mu is not None and res.contour is not None:
                metrics["mu_L2"].append(float(np.linalg.norm(res.mu[i] - res.contour[i])))
            if res.mode is not None and res.contour is not None:
                metrics["mode_L2"].append(float(np.linalg.norm(res.mode[i] - res.contour[i])))
            if res.instant_uncertainty:
                for key, unc in res.instant_uncertainty.items():
                    uncertainties[key].append(float(unc[i]))

    table = {"id": ids}
    if any(q != "Unknown" for q in qualities):
        table["image_quality"] = qualities
        # ordinal score column so quality joins the correlation grid
        scores = [_QUALITY_SCORE.get(q, np.nan) for q in qualities]
        if np.isfinite(np.asarray(scores)).any():
            metrics["image_quality_score"] = scores
    table.update({k: v for k, v in metrics.items() if len(v) == len(ids)})
    table.update({k: v for k, v in uncertainties.items() if len(v) == len(ids)})
    Table.from_columns(table).to_csv(out_dir / "instant_metrics.csv")
    np.save(out_dir / "data_instant.npy",
            {"metrics": dict(metrics), "uncertainty": dict(uncertainties), "ids": ids},
            allow_pickle=True)

    summary = {k: float(np.nanmean(v)) for k, v in metrics.items()}
    if uncertainties and metrics:
        summary.update(dataframe_to_dict(compute_correlations(uncertainties, metrics), "corr-"))
    return summary
