"""Shared evaluation helpers: calibration curves, threshold sweeps,
correlations, multi-class Dice, and the result table.

Counterpart of contouring_uncertainty_tpu/results/utils.py, numeric parts
only, in numpy on the host as there; the figures (`_plot_*`) are not ported
(the machine with the card has no matplotlib). `Table` takes the place of
the pandas DataFrames the JAX package builds and writes the same CSV text.
"""

from __future__ import annotations

import csv
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class Table:
    """Rows of named cells: `rows` maps each index label to {column: value}.

    The columns are the rows' keys in order of first appearance, as
    `pandas.DataFrame(rows).T` orders them; a row without a column holds
    NaN there. `to_csv` writes what pandas' `to_csv` writes for such a
    frame: an empty first header cell for the index, NaN and None as empty
    fields, booleans as True/False and floats as their repr."""

    def __init__(self, rows: Dict[Any, Dict[str, Any]]):
        self.rows = rows
        self.columns: List[str] = list(dict.fromkeys(c for row in rows.values() for c in row))

    @classmethod
    def from_columns(cls, columns: Dict[str, Sequence]) -> "Table":
        """A table from equal-length columns, indexed 0..n-1 (as
        `pandas.DataFrame(columns)`)."""
        n = len(next(iter(columns.values()))) if columns else 0
        return cls({i: {c: values[i] for c, values in columns.items()} for i in range(n)})

    @property
    def index(self) -> List:
        return list(self.rows)

    def column(self, name: str) -> np.ndarray:
        """The column as float64 (NaN where a row lacks it)."""
        return np.array([_as_float(row.get(name, np.nan)) for row in self.rows.values()],
                        np.float64)

    def flags(self, name: str) -> np.ndarray:
        """The column as booleans, as pandas' `astype(bool)` (NaN is True)."""
        return np.array([bool(row.get(name, np.nan)) for row in self.rows.values()])

    def loc(self, row, name: str):
        return self.rows[row].get(name, np.nan)

    def to_csv(self, path) -> None:
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(["", *self.columns])
            for label, row in self.rows.items():
                writer.writerow([_cell(label), *(_cell(row.get(c)) for c in self.columns)])


def _as_float(value) -> float:
    return np.nan if value is None else float(value)


def _cell(value) -> str:
    if value is None:
        return ""
    if isinstance(value, (bool, np.bool_)):
        return str(bool(value))
    if isinstance(value, (float, np.floating)):
        return "" if np.isnan(value) else repr(float(value))
    return str(value)


def dice(pred: np.ndarray, gt: np.ndarray, labels, all_classes: bool = False) -> Dict[str, float]:
    """Per-class + mean Dice of int label maps."""
    out = {}
    scores = []
    for lab in labels:
        if int(lab) == 0:
            continue
        p = pred == int(lab)
        g = gt == int(lab)
        denom = p.sum() + g.sum()
        score = 2.0 * (p & g).sum() / denom if denom > 0 else 1.0
        scores.append(score)
        if all_classes:
            out[f"Dice_{getattr(lab, 'name', lab)}"] = score
    out["Dice"] = float(np.mean(scores)) if scores else np.nan
    return out


def compute_calibration(error: np.ndarray, uncertainty: np.ndarray, nb_bins: int = 10,
                        filters: Optional[np.ndarray] = None):
    """Uniform-bin UCE; `filters` keeps only the marked samples."""
    if filters is not None:
        keep = np.asarray(filters, bool)
        error, uncertainty = error[keep], uncertainty[keep]
    bounds = np.linspace(uncertainty.min(), uncertainty.max(), nb_bins + 1)
    ece = 0.0
    conf, acc, sizes = [], [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        in_bin = (uncertainty > lo) & (uncertainty < hi)
        prop = in_bin.mean()
        if prop > 0:
            a = error[in_bin].mean()
            c = uncertainty[in_bin].mean()
            ece += abs(c - a) * prop
            conf.append(c)
            acc.append(a)
            sizes.append(int(in_bin.sum()))
    return float(ece), conf, acc, sizes


def compute_adaptive_calibration(error: np.ndarray, uncertainty: np.ndarray, nb_bins: int = 10,
                                 filters: Optional[np.ndarray] = None):
    """Equal-mass-bin UCE."""
    if filters is not None:
        keep = np.asarray(filters, bool)
        error, uncertainty = error[keep], uncertainty[keep]
    idx = np.argsort(uncertainty)
    u_bins = np.array_split(uncertainty[idx], nb_bins)
    e_bins = np.array_split(error[idx], nb_bins)
    ece = 0.0
    conf, acc, sizes = [], [], []
    for u, e in zip(u_bins, e_bins):
        if len(u) == 0:
            continue
        prop = len(u) / nb_bins
        ece += abs(u.mean() - e.mean()) * prop
        conf.append(u.mean())
        acc.append(e.mean())
        sizes.append(len(u))
    return float(ece), conf, acc, sizes


def calibration(uncertainties: Dict, metrics: Dict, u_keys: Sequence[str],
                m_keys: Sequence[str], adaptive: bool = False) -> Dict[str, float]:
    """UCE of each (uncertainty, metric) pair over their finite samples."""
    results = {}
    for u_key, m_key in zip(u_keys, m_keys):
        if u_key not in uncertainties or m_key not in metrics:
            continue
        u = np.asarray(uncertainties[u_key], float)
        e = np.asarray(metrics[m_key], float)
        ok = np.isfinite(u) & np.isfinite(e)
        if ok.sum() < 2:
            continue
        fn = compute_adaptive_calibration if adaptive else compute_calibration
        ece, _, _, _ = fn(e[ok], u[ok])
        results[f"calibration-{m_key}-{u_key}"] = ece
    return results


def thresholded_metrics(uncertainties: Dict, metrics: Dict, u_keys, m_keys,
                        nb_bins: int = 10) -> Dict[str, float]:
    """Mean error among samples below each uncertainty percentile threshold:
    per-threshold mean errors and a spearman `monoticity_*` scalar per pair."""
    from scipy import stats as _st

    results = {}
    for u_key, m_key in zip(u_keys, m_keys):
        if u_key not in uncertainties or m_key not in metrics:
            continue
        u = np.asarray(uncertainties[u_key], float)
        e = np.asarray(metrics[m_key], float)
        ok = np.isfinite(u) & np.isfinite(e)
        u, e = u[ok], e[ok]
        if len(u) < nb_bins:
            continue
        u_sorted = np.sort(u)
        cut_idx = np.linspace(1, len(u_sorted) - 1, nb_bins).astype(int)
        pcts = cut_idx / len(u_sorted) * 100
        errs = []
        for pct, t in zip(pcts, u_sorted[cut_idx]):
            kept = e[u < t]
            errs.append(float(kept.mean()) if len(kept) else np.nan)
            if len(kept):
                results[f"threshold-{m_key}-{u_key}-{pct:.0f}"] = errs[-1]
        mono = _st.spearmanr(pcts, errs, nan_policy="omit")[0]
        results[f"monoticity_{m_key}-{u_key}"] = float(mono)
    return results


def thresholded_correlation(uncertainties: Dict, metrics: Dict, u_key: str,
                            m_key: str, n: int = 20) -> Dict[str, float]:
    """Uncertainty-error correlation among samples above a sweep of
    uncertainty / error thresholds; returns the tail correlations at the
    median thresholds."""
    if u_key not in uncertainties or m_key not in metrics:
        return {}
    u = np.asarray(uncertainties[u_key], float)
    e = np.asarray(metrics[m_key], float)
    ok = np.isfinite(u) & np.isfinite(e)
    u, e = u[ok], e[ok]
    if len(u) < 3 or u.min() == u.max():
        return {}
    thr_u = np.linspace(u.min(), u.max(), n)
    thr_e = np.linspace(e.min(), e.max(), n)
    corr_u, corr_e = [], []
    for i in range(n):
        idx = u > thr_u[i]
        corr_u.append(_pearson(u[idx], e[idx]) if idx.sum() > 1 else np.nan)
        idx = e > thr_e[i]
        corr_e.append(_pearson(u[idx], e[idx]) if idx.sum() > 1 else np.nan)
    mid = n // 2
    return {
        f"tail_corr_u-{m_key}-{u_key}": float(corr_u[mid]),
        f"tail_corr_e-{m_key}-{u_key}": float(corr_e[mid]),
    }


def _pearson(x: np.ndarray, y: np.ndarray) -> float:
    if x.size == 0 or y.size == 0:
        return np.nan
    x = x - x.mean()
    y = y - y.mean()
    denom = np.sqrt((x * x).sum() * (y * y).sum())
    return float((x * y).sum() / denom) if denom > 0 else np.nan


def _cooks_distance_filter(x: np.ndarray, y: np.ndarray, factor: float = 4.0):
    """Drop points with Cook's distance > factor/n under a simple linear fit."""
    n = len(x)
    if n < 4:
        return np.ones(n, bool)
    design = np.stack([np.ones(n), x], 1)
    hat_core = np.linalg.pinv(design.T @ design)
    beta = hat_core @ design.T @ y
    resid = y - design @ beta
    mse = (resid ** 2).sum() / max(n - 2, 1)
    leverage = np.einsum("ni,ij,nj->n", design, hat_core, design)
    denom = 2 * mse * (1 - leverage) ** 2
    # A zero-denominator point is an exact-leverage outlier: excluded.
    cooks = np.divide(resid ** 2 * leverage, denom,
                      out=np.full(n, np.inf), where=denom > 0)
    return cooks < factor / n


def compute_correlations(uncertainties: Dict, metrics: Dict, filters=None) -> Table:
    """Pearson correlation of every (uncertainty, metric) pair, after
    Cook's-distance outlier removal: a Table indexed by uncertainty."""
    rows = {}
    for u_key, u_vals in uncertainties.items():
        row = {}
        for m_key, m_vals in metrics.items():
            u = np.asarray(u_vals, float)
            e = np.asarray(m_vals, float)
            ok = np.isfinite(u) & np.isfinite(e)
            if filters is not None:
                ok &= np.asarray(filters, bool)
            u, e = u[ok], e[ok]
            if len(u) < 3:
                row[m_key] = np.nan
                continue
            keep = _cooks_distance_filter(u, e)
            row[m_key] = _pearson(u[keep], e[keep])
        rows[u_key] = row
    return Table(rows)


def dataframe_to_dict(df: Table, prefix: str = "") -> Dict[str, float]:
    out = {}
    for u_key in df.index:
        for m_key in df.columns:
            out[f"{prefix}{u_key}-{m_key}".replace(" ", "_")] = df.loc(u_key, m_key)
    return out
