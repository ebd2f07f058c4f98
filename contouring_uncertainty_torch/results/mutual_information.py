"""Error <-> uncertainty mutual information, with the morphological-uncertainty
baseline.

Counterpart of contouring_uncertainty_tpu/results/mutual_information.py,
with scipy on the host as there.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np
from scipy import ndimage
from scipy.stats import norm

from contouring_uncertainty_torch.results import register


def compute_morph_unc(pred: np.ndarray, thickness: int = 5) -> np.ndarray:
    """Morphological baseline: Gaussian-weighted erosion/dilation shells
    around the prediction boundary (reference :50-75)."""
    dil = pred.copy().astype(bool)
    ero = pred.copy().astype(bool)
    prev_d, prev_e = dil.copy(), ero.copy()
    umap = np.zeros_like(pred, dtype=float)
    footprint = np.ones((3, 3))
    for j in range(thickness):
        dil = ndimage.binary_dilation(dil, structure=footprint)
        ero = ndimage.binary_erosion(ero, structure=footprint)
        shells = (prev_e ^ ero).astype(float) + (prev_d ^ dil).astype(float)
        umap += norm.pdf(j, loc=0, scale=1.5) * np.clip(shells, 0, 1)
        prev_d, prev_e = dil.copy(), ero.copy()
    return umap


def compute_mi(error: np.ndarray, uncertainty: np.ndarray, normalized: bool = True) -> float:
    """Histogram mutual information between binary error and uncertainty
    (reference :77-103)."""
    hist_2d, _, _ = np.histogram2d(error.ravel(), uncertainty.ravel())
    pxy = hist_2d / hist_2d.sum()
    px = pxy.sum(1)
    py = pxy.sum(0)
    px_py = px[:, None] * py[None, :]
    nz = pxy > 0
    mi = float(np.sum(pxy[nz] * np.log(pxy[nz] / px_py[nz])))
    if normalized:
        hx = -np.sum(px[px > 0] * np.log(px[px > 0]))
        hy = -np.sum(py[py > 0] * np.log(py[py > 0]))
        mi = 2 * mi / (hx + hy) if (hx + hy) > 0 else 0.0
    return mi


@register("mutual_info")
def uncertainty_error_mutual_info(results: List, out_dir: Path) -> dict:
    mi_umap, mi_entropy, mi_morph = [], [], []
    for res in results:
        if res.gt is None:
            continue
        for i in range(res.img.shape[0]):
            error = (res.pred[i] != res.gt[i]).astype(float)
            if res.uncertainty_map is not None:
                mi_umap.append(compute_mi(error, res.uncertainty_map[i]))
            if res.entropy_map is not None:
                mi_entropy.append(compute_mi(error, res.entropy_map[i]))
            morph = compute_morph_unc((res.pred[i] != 0).astype(np.uint8))
            mi_morph.append(compute_mi(error, morph))
    out = {}
    if mi_umap:
        out["mi_umap"] = float(np.mean(mi_umap))
    if mi_entropy:
        out["mi_entropy"] = float(np.mean(mi_entropy))
    if mi_morph:
        out["mi_morphological_baseline"] = float(np.mean(mi_morph))
    return out
