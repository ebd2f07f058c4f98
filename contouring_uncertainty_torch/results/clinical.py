"""Clinical metric propagation: LV area, FAC, GLS, Simpson EDV/ESV/EF over the
Monte-Carlo sample population, with the aleatoric/epistemic split, the
calibration of each metric's spread and physiological rejection.

Counterpart of contouring_uncertainty_tpu/results/clinical.py. Per view the
(N, T_e, T_a, H, W) sample masks are uploaded to the device once; the areas
of all samples come from one reduction and the spline perimeters of all
sample contours (with the predicted and reference contours) from one
batched call. Per patient, the Simpson volumes of all samples of both views
(with the predicted and reference masks) come from one batched call. Only
scalars come back to the host, where the tables are assembled in numpy.

Not ported: the figures (the calibration and correlation plots and the
per-view dashboards of results/metric_figures.py); the machine with the
card has no matplotlib. The numeric half of the calibration plot, the
`{metric}_uce` and `{metric}_a-uce` summary keys, is kept.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from contouring_uncertainty_torch.data.config import Label
from contouring_uncertainty_torch.results import register
from contouring_uncertainty_torch.results.utils import (
    Table,
    _pearson,
    compute_adaptive_calibration,
    compute_calibration,
)
from contouring_uncertainty_torch.utils import clinical as C


def aleatoric_epistemic_uncertainty(metric_mc: np.ndarray):
    """(Te, Ta) MC metric values -> (mean, aleatoric std, epistemic std, total)."""
    means = np.nanmean(metric_mc, axis=-1)
    stds = np.nanstd(metric_mc, axis=-1)
    mean = float(np.nanmean(means))
    epistemic = float(np.nanstd(means))
    aleatoric = float(np.nanmean(stds))
    return mean, aleatoric, epistemic, epistemic + aleatoric


def _metric_row(pred, gt, mc, min_value, max_value):
    mc = np.asarray(mc, float)
    sample_reject = (mc < min_value) | (mc > max_value)
    mc = np.where(sample_reject, np.nan, mc)
    mean, al, ep, tot = aleatoric_epistemic_uncertainty(mc)
    reject = not (min_value < pred <= max_value)
    if sample_reject.mean() > 0.5:
        reject = True
    return {
        "pred": float(pred),
        "gt": float(gt) if gt is not None else np.nan,
        "error": float(abs(mean - gt)) if gt is not None else np.nan,
        "std": tot,
        "mean": mean,
        "aleatoric_std": al,
        "epistemic_std": ep,
        "reject": bool(reject),
        "sample_reject_frac": float(sample_reject.mean()),
    }


def merge_volume_df(patient_df: Table) -> Table:
    """Fold the patient EDV/ESV columns into per-instant 'Volume' rows
    ('{patient}/ES' rows first, then '{patient}/ED')."""
    rows = {}
    for prefix, inst in (("ESV_", "ES"), ("EDV_", "ED")):
        for pid, row in patient_df.rows.items():
            rows[f"{pid}/{inst}"] = {c.replace(prefix, "Volume_"): v for c, v in row.items()
                                     if c.startswith(prefix)}
    return Table(rows)


def metric_calibration(df: Table, metric: str, summary: Dict) -> None:
    """Uniform and adaptive UCE of one clinical metric's MC spread against
    its error, as '{metric}_uce' / '{metric}_a-uce' summary keys; rejected
    rows are left out when at least two remain."""
    std_col, err_col = f"{metric}_std", f"{metric}_error"
    if std_col not in df.columns or err_col not in df.columns:
        return
    std = df.column(std_col)
    err = df.column(err_col)
    ok = np.isfinite(std) & np.isfinite(err)
    std, err = std[ok], err[ok]
    if len(std) < 2:
        return
    filters = None
    if f"{metric}_reject" in df.columns:
        filters = ~df.flags(f"{metric}_reject")[ok]
        if filters.sum() < 2:
            filters = None
    summary[f"{metric}_uce"] = compute_calibration(err, std, filters=filters)[0]
    summary[f"{metric}_a-uce"] = compute_adaptive_calibration(err, std, filters=filters)[0]


def _ed_es(res):
    inst = res.instants or {"ED": 0, "ES": min(1, res.img.shape[0] - 1)}
    return inst["ED"], inst["ES"]


def _view_gls(res, samples: torch.Tensor, ed: int, es: int, device: torch.device):
    """(GLS MC population (Te, Ta), predicted GLS, reference GLS or None).

    With contour samples: spline perimeters of every sample contour and of
    the predicted and reference ED/ES contours, in one call. Without them
    (segmentation results): the mask-space longitudinal lengths of the ED
    and ES label maps of every sample, the prediction and the reference,
    in one call."""
    te, ta = samples.shape[1:3]
    if res.contour_samples is not None and res.mu is not None:
        contours = torch.as_tensor(res.contour_samples, device=device)
        refs = [res.mu] + ([res.contour] if res.contour is not None else [])
        ends = torch.as_tensor(np.stack([ref[i] for ref in refs for i in (ed, es)]),
                               dtype=contours.dtype, device=device)
        per = C.contour_perimeter(torch.cat([contours.reshape(-1, *contours.shape[-2:]), ends]))
        per_mc = per[:-len(ends)].reshape(contours.shape[:3]).cpu().numpy()
        gls_mc = (per_mc[ed] - per_mc[es]) / per_mc[ed]
        per_ref = per[-len(ends):].reshape(len(refs), 2)  # (ref, [ED, ES])
        gls = ((per_ref[:, 0] - per_ref[:, 1]) / per_ref[:, 0]).cpu().numpy()
        return gls_mc, float(gls[0]), float(gls[1]) if len(refs) > 1 else None
    use_myo = Label.MYO in tuple(res.labels)
    h, w = samples.shape[-2:]
    refs = [res.pred] + ([res.gt] if res.gt is not None else [])
    segs = [torch.round(samples[[ed, es]].to(torch.float32)).reshape(2, te * ta, h, w)]
    segs += [torch.as_tensor(ref[[ed, es]], dtype=torch.float32, device=device)[:, None]
             for ref in refs]
    lens = C.mask_longitudinal_length(torch.cat(segs, dim=1), use_myo=use_myo).cpu().numpy()
    lens_mc = lens[:, :te * ta].reshape(2, te, ta)
    gls_mc = (lens_mc[0] - lens_mc[1]) / lens_mc[0]  # (Te, Ta), ED-relative
    gls = (lens[0, te * ta:] - lens[1, te * ta:]) / lens[0, te * ta:]
    return gls_mc, float(gls[0]), float(gls[1]) if len(refs) > 1 else None


def _patient_volumes(a2c, a4c, masks: Dict[str, torch.Tensor], device: torch.device):
    """Simpson EDV/ESV of every sample of both views, then of the predicted
    masks and (when both views have one) the reference masks, in one call:
    (edv, esv) f32 arrays of Te*Ta + 1 or + 2 values."""
    ed2, es2 = _ed_es(a2c)
    ed4, es4 = _ed_es(a4c)
    with_gt = a2c.gt is not None and a4c.gt is not None

    def stack(res, inst):
        hard = masks[res.id][inst]
        sets = [hard.reshape(-1, *hard.shape[-2:]).to(torch.float32)]
        for ref in [res.pred] + ([res.gt] if with_gt else []):
            sets.append(torch.as_tensor(ref[inst] != 0, dtype=torch.float32, device=device)[None])
        return torch.cat(sets)

    def spacing(res):
        return res.voxelspacing[-2:] if res.voxelspacing is not None else (1.0, 1.0)

    edv, esv = C.compute_left_ventricle_volumes(
        stack(a2c, ed2), stack(a2c, es2), spacing(a2c),
        stack(a4c, ed4), stack(a4c, es4), spacing(a4c))
    return edv.cpu().numpy(), esv.cpu().numpy(), with_gt


@register("clinical_metrics", on_device=True)
def clinical_metrics(results: List, out_dir: Path, device: torch.device) -> dict:
    out_dir = Path(out_dir) / "clinical"
    out_dir.mkdir(parents=True, exist_ok=True)

    instant_rows: Dict[str, Dict] = {}
    view_rows: Dict[str, Dict] = {}
    patients: Dict[str, Dict[str, object]] = defaultdict(dict)
    masks: Dict[str, torch.Tensor] = {}  # view id -> (N, Te, Ta, H, W) bool, on device

    for res in results:
        if res.pred_samples is None:
            continue
        voxelarea = float(np.prod(res.voxelspacing[-2:])) if res.voxelspacing is not None else 1.0
        samples = torch.as_tensor(res.pred_samples, device=device)  # (N, Te, Ta, H, W)
        masks[res.id] = samples > 0.5
        areas_mc = C.lv_area(masks[res.id]).cpu().numpy() * voxelarea  # (N, Te, Ta)

        # ---- per-instant area ----
        for inst_key, inst in (res.instants or {}).items():
            pred_area = float((res.pred[inst] != 0).sum()) * voxelarea
            gt_area = float((res.gt[inst] != 0).sum()) * voxelarea if res.gt is not None else None
            row = _metric_row(pred_area, gt_area, areas_mc[inst], 0.0, np.inf)
            instant_rows[f"{res.id}/{inst_key}"] = {f"Area_{k}": v for k, v in row.items()}

        # ---- per-view FAC / GLS ----
        ed, es = _ed_es(res)
        fac_mc = (areas_mc[ed] - areas_mc[es]) / areas_mc[ed]
        pred_fac = float(
            ((res.pred[ed] != 0).sum() - (res.pred[es] != 0).sum()) / max((res.pred[ed] != 0).sum(), 1)
        )
        gt_fac = None
        if res.gt is not None:
            gt_fac = float(
                ((res.gt[ed] != 0).sum() - (res.gt[es] != 0).sum()) / max((res.gt[ed] != 0).sum(), 1)
            )
        row = {f"FAC_{k}": v for k, v in _metric_row(pred_fac, gt_fac, fac_mc, 0.0, 1.0).items()}
        gls_mc, pred_gls, gt_gls = _view_gls(res, samples, ed, es, device)
        row.update({f"GLS_{k}": v for k, v in _metric_row(pred_gls, gt_gls, gls_mc, 0.0, 1.0).items()})
        view_rows[res.id] = row

        pid, _, view = res.id.rpartition("/")
        patients[pid][view] = res

    # ---- per-patient Simpson volumes / EF ----
    patient_rows: Dict[str, Dict] = {}
    for pid, views in patients.items():
        a2c = views.get("2CH") or views.get("2C")
        a4c = views.get("4CH") or views.get("4C")
        if a2c is None or a4c is None:
            continue
        edv, esv, with_gt = _patient_volumes(a2c, a4c, masks, device)
        te, ta = a2c.pred_samples.shape[1:3]
        n_mc = te * ta
        edv_mc = edv[:n_mc].reshape(te, ta)
        esv_mc = esv[:n_mc].reshape(te, ta)
        ef_mc = (edv_mc - esv_mc) / edv_mc
        pred_edv, pred_esv = float(edv[n_mc]), float(esv[n_mc])
        pred_ef = (pred_edv - pred_esv) / pred_edv if pred_edv else np.nan
        if with_gt:
            gt_edv, gt_esv = float(edv[n_mc + 1]), float(esv[n_mc + 1])
            gt_ef = (gt_edv - gt_esv) / gt_edv if gt_edv else np.nan
        else:
            gt_edv = gt_esv = gt_ef = None

        row = {}
        row.update({f"EDV_{k}": v for k, v in _metric_row(pred_edv, gt_edv, edv_mc, 0.0, np.inf).items()})
        row.update({f"ESV_{k}": v for k, v in _metric_row(pred_esv, gt_esv, esv_mc, 0.0, np.inf).items()})
        row.update({f"EF_{k}": v for k, v in _metric_row(pred_ef, gt_ef, ef_mc, 0.0, 1.0).items()})
        patient_rows[pid] = row

    summary = {}
    dfs = {}
    for name, rows in (("instant", instant_rows), ("view", view_rows), ("patient", patient_rows)):
        if not rows:
            continue
        df = Table(rows)
        dfs[name] = df
        df.to_csv(out_dir / f"{name}_df.csv")
        for col in df.columns:
            if col.endswith("_error"):
                summary[f"{name}/{col}"] = float(np.nanmean(df.column(col)))
        # Correlation of uncertainty (std) with error per metric family.
        for metric in dict.fromkeys(c.split("_")[0] for c in df.columns):
            err_col, std_col = f"{metric}_error", f"{metric}_std"
            if err_col in df.columns and std_col in df.columns:
                e = df.column(err_col)
                s = df.column(std_col)
                ok = np.isfinite(e) & np.isfinite(s)
                if ok.sum() > 2:
                    summary[f"{name}/corr-{metric}_std-error"] = _pearson(s[ok], e[ok])
    # Rejection rates.
    for name in ("view", "patient"):
        if name in dfs:
            df = dfs[name]
            for col in [c for c in df.columns if c.endswith("_reject")]:
                summary[f"{name}/{col}_rate"] = float(df.flags(col).mean())

    # Fourth table: per-instant Volume rows of the patient EDV/ESV columns.
    if "patient" in dfs:
        dfs["volume"] = merge_volume_df(dfs["patient"])
        dfs["volume"].to_csv(out_dir / "volume_df.csv")

    # Calibration of each clinical metric's MC spread.
    families = {
        "instant": ("Area",),
        "view": ("FAC", "GLS"),
        "patient": ("EF", "ESV", "EDV"),
        "volume": ("Volume",),
    }
    for name, metrics in families.items():
        if name in dfs:
            for metric in metrics:
                metric_calibration(dfs[name], metric, summary)
    return summary
