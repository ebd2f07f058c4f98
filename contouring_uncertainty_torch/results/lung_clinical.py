"""JSRT clinical metrics over the Monte-Carlo population: lung and heart
areas, the cardiothoracic ratio and, for contour tasks, the area of each
structure's landmark contour.

Counterpart of contouring_uncertainty_tpu/results/lung_clinical.py. Per
view, the prediction, the reference and the (T_e, T_a) sample label maps
of the film (frame 0) reduce on the device in one `lung_mask_metrics`
call; the contour areas of the samples, the prediction and the reference
in one `contour_area` call per structure. Only scalars come back to the
host, where `lung_clinical/view_df.csv` is written through `Table`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from contouring_uncertainty_torch.data.lung import N_POINTS, STRUCTURES
from contouring_uncertainty_torch.results import register
from contouring_uncertainty_torch.results.clinical import _metric_row
from contouring_uncertainty_torch.results.utils import Table, _pearson
from contouring_uncertainty_torch.utils import clinical as C

_MASK_METRICS = {"LungArea": (0.0, np.inf), "HeartArea": (0.0, np.inf), "CTR": (0.0, 1.0)}


def _label_maps(res, device) -> torch.Tensor:
    """The film's (T_e * T_a) sample label maps, then the prediction, then
    the reference when there is one: (M, H, W) int32 on `device`."""
    samples = torch.as_tensor(res.pred_samples[0], device=device).to(torch.float32)
    maps = [torch.round(samples).to(torch.int32).flatten(0, -3),
            torch.as_tensor(res.pred[:1], device=device).to(torch.int32)]
    if res.gt is not None:
        maps.append(torch.as_tensor(res.gt[:1], device=device).to(torch.int32))
    return torch.cat(maps)


@register("lung_clinical", on_device=True)
def lung_clinical(results: List, out_dir: Path, device: torch.device) -> Dict:
    out = Path(out_dir) / "lung_clinical"
    out.mkdir(parents=True, exist_ok=True)
    rows: Dict[str, Dict] = {}
    for res in results:
        if res.pred is None or res.pred_samples is None:
            continue
        mc_shape = res.pred_samples.shape[1:3]
        n_mc = int(np.prod(mc_shape))
        metrics = C.lung_mask_metrics(_label_maps(res, device)).cpu().numpy()
        mc = metrics[:n_mc].reshape(*mc_shape, 3)
        row: Dict = {}
        for j, (name, (lo, hi)) in enumerate(_MASK_METRICS.items()):
            gt = float(metrics[n_mc + 1, j]) if res.gt is not None else None
            row.update({f"{name}_{k}": v for k, v in _metric_row(
                float(metrics[n_mc, j]), gt, mc[..., j], lo, hi).items()})

        # Per-structure landmark areas (contour tasks; the label map cannot
        # tell the lungs apart, they share one label).
        if (res.contour_samples is not None and res.mu is not None
                and res.mu.shape[-2] == N_POINTS):
            contours = [torch.as_tensor(res.contour_samples[0], device=device).flatten(0, -3),
                        torch.as_tensor(res.mu[:1], device=device)]
            if res.contour is not None:
                contours.append(torch.as_tensor(res.contour[:1], device=device))
            contours = torch.cat(contours).to(torch.float32)
            for sname, a, b, _ in STRUCTURES:
                areas = C.contour_area(contours[:, a:b]).cpu().numpy()
                gt = float(areas[n_mc + 1]) if res.contour is not None else None
                row.update({f"Area_{sname}_{k}": v for k, v in _metric_row(
                    float(areas[n_mc]), gt, areas[:n_mc].reshape(mc_shape), 0.0,
                    np.inf).items()})
        rows[res.id] = row

    if not rows:
        return {}
    df = Table(rows)
    df.to_csv(out / "view_df.csv")

    summary: Dict[str, float] = {}
    for m in sorted({c.rsplit("_", 1)[0] for c in df.columns if c.endswith("_error")}):
        err, std = df.column(f"{m}_error"), df.column(f"{m}_std")
        ok = np.isfinite(err)
        if ok.any():
            summary[f"{m}_error"] = float(np.nanmean(err[ok]))
            summary[f"{m}_corr"] = _pearson(std[ok], err[ok])
        summary[f"{m}_reject_rate"] = float(df.flags(f"{m}_reject").mean())
    return summary
