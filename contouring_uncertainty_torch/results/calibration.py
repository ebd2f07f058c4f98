"""Pixel-level calibration of uncertainty maps: ECE / MCE / adaptive ECE over
foreground pixels.

Counterpart of contouring_uncertainty_tpu/results/calibration.py, in numpy
on the host as there.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

from contouring_uncertainty_torch.results import register


def _ece_mce(confidences: np.ndarray, accuracies: np.ndarray, nb_bins: int = 20):
    bounds = np.linspace(0, 1, nb_bins + 1)
    ece = 0.0
    mce = 0.0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        in_bin = (confidences > lo) & (confidences <= hi)
        prop = in_bin.mean()
        if prop > 0:
            gap = abs(confidences[in_bin].mean() - accuracies[in_bin].mean())
            ece += gap * prop
            mce = max(mce, gap)
    return float(ece), float(mce)


def _adaptive_ece(confidences: np.ndarray, accuracies: np.ndarray, nb_bins: int = 20):
    idx = np.argsort(confidences)
    c_bins = np.array_split(confidences[idx], nb_bins)
    a_bins = np.array_split(accuracies[idx], nb_bins)
    ece = 0.0
    mce = 0.0
    n = len(confidences)
    for c, a in zip(c_bins, a_bins):
        if len(c) == 0:
            continue
        gap = abs(c.mean() - a.mean())
        ece += gap * len(c) / n
        mce = max(mce, gap)
    return float(ece), float(mce)


def _confidence_accuracy(res, prob_map: np.ndarray):
    """Per-pixel confidence (1 - normalized uncertainty) and accuracy."""
    conf = 1.0 - np.clip(prob_map, 0.0, None)
    if prob_map.max() > 1.0:
        conf = 1.0 - prob_map / prob_map.max()
    acc = (res.pred == res.gt).astype(np.float32)
    return conf, acc


@register("calibration")
def pixel_calibration(results: List, out_dir: Path) -> dict:
    out = {}
    for name, attr in (("ece", "uncertainty_map"), ("entropy_ece", "entropy_map")):
        confs, accs, fgs = [], [], []
        for res in results:
            prob = getattr(res, attr, None)
            if prob is None or res.gt is None:
                continue
            conf, acc = _confidence_accuracy(res, prob)
            fg = (res.pred + res.gt) != 0
            confs.append(conf)
            accs.append(acc)
            fgs.append(fg)
        if not confs:
            continue
        conf = np.concatenate([c.ravel()[f.ravel()] for c, f in zip(confs, fgs)])
        acc = np.concatenate([a.ravel()[f.ravel()] for a, f in zip(accs, fgs)])
        if len(conf) == 0:
            continue
        ece, mce = _ece_mce(conf, acc)
        aece, amce = _adaptive_ece(conf, acc)
        prefix = name.replace("_ece", "")
        key = "" if prefix == "ece" else "entropy_"
        out[f"{key}ece"] = ece
        out[f"{key}mce"] = mce
        out[f"{key}aece"] = aece
        out[f"{key}amce"] = amce

        # Per-instant sample ECEs (reference averages the first ones).
        sample_eces = []
        for c, a, f in zip(confs, accs, fgs):
            for i in range(c.shape[0]):
                sel = f[i].ravel()
                if sel.sum() > 10:
                    e, _ = _ece_mce(c[i].ravel()[sel], a[i].ravel()[sel])
                    sample_eces.append(e)
        if sample_eces:
            out[f"sample_{key}ece"] = float(np.mean(sample_eces))
    return out
