"""The films the benchmark trains on, made from the run's seed.

Frozen copies, so that a later change to the program's generators does
not change the benchmark's inputs:

- `make_camus_tree` and its helpers (`lv_contour_points`, `_fill_poly`,
  `make_sample`): contouring_uncertainty_torch/data/synthetic.py at commit
  e2ff7a5, draw for draw. The tree is returned as nested `Node`s, which the
  drivers hand to the program's `CamusContourData.from_arrays` as its
  `Group`s.

numpy and scipy only; nothing of the program is imported here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import numpy as np

# data/config.py Label: background, LV cavity, myocardium.
LABEL_LV, LABEL_MYO = 1, 2


@dataclass
class Node:
    """One group of a CAMUS-layout file: members (nodes or arrays) and attrs."""

    members: Dict[str, Any] = field(default_factory=dict)
    attrs: Dict[str, Any] = field(default_factory=dict)


def lv_contour_points(rng: np.random.Generator, k: int = 21, size: int = 256) -> np.ndarray:
    """Random LV endocardium contour, (K, 2) in (x, y), base -> apex -> base."""
    s = size / 256.0
    cx = size / 2 + rng.uniform(-15, 15) * s
    base_y = size * 0.75 + rng.uniform(-15, 15) * s
    apex_y = size * 0.2 + rng.uniform(-10, 15) * s
    half_w = size * 0.18 + rng.uniform(-8, 12) * s
    tilt = rng.uniform(-0.15, 0.15)
    t = np.linspace(0.0, np.pi, k)
    x = cx + half_w * np.cos(t)
    height = base_y - apex_y
    y = base_y - height * np.sin(t) ** 0.9
    wobble = rng.normal(scale=1.5 * s, size=k)
    x = x + wobble * np.sin(t)
    xr = cx + (x - cx) * np.cos(tilt) - (y - base_y) * np.sin(tilt)
    yr = base_y + (x - cx) * np.sin(tilt) + (y - base_y) * np.cos(tilt)
    pts = np.stack([xr, yr], axis=-1)
    return pts[::-1].astype(np.float32)


def _fill_poly(points: np.ndarray, size: int) -> np.ndarray:
    """Even-odd fill of a closed polygon (P, 2) at pixel centres."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    p0 = points.astype(np.float64)
    p1 = np.roll(p0, -1, axis=0)
    inside = np.zeros((size, size), bool)
    for (x0, y0), (x1, y1) in zip(p0, p1):
        if y0 == y1:
            continue
        straddle = (y0 > yy) != (y1 > yy)
        x_cross = x0 + (yy - y0) * (x1 - x0) / (y1 - y0)
        inside ^= straddle & (xx < x_cross)
    return inside


def make_sample(rng: np.random.Generator, k: int = 21,
                size: int = 256) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(img (H, W) f32 in [0, 1], gt (H, W) uint8 labels, contour (K, 2))."""
    from scipy.signal import convolve2d

    contour = lv_contour_points(rng, k, size)
    lv = _fill_poly(contour, size)
    center = contour.mean(axis=0)
    ring_pts = center + (contour - center) * 1.25
    myo = _fill_poly(ring_pts, size) & ~lv
    base_y = min(contour[0, 1], contour[-1, 1])
    myo &= np.arange(size)[:, None] <= base_y
    gt = np.zeros((size, size), np.uint8)
    gt[myo] = LABEL_MYO
    gt[lv] = LABEL_LV
    speckle = rng.gamma(2.0, 0.25, size=(size, size))
    img = 0.45 * speckle
    img = np.where(lv, img * 0.35, img)
    img = np.where(myo, img * 1.6, img)
    img = convolve2d(img, np.ones((3, 3)) / 9.0, mode="same", boundary="symm")
    return np.clip(img, 0, 1).astype(np.float32), gt, contour


def make_camus_tree(n_patients: int = 8, k: int = 21, size: int = 256, seed: int = 0,
                    fold: int = 5) -> Node:
    """A CAMUS-layout tree: `n_patients` patients split 60/20/20, a 2CH and
    a 4CH view of two frames (ED, ES) each."""
    rng = np.random.default_rng(seed)
    patients = [f"patient{i:04d}" for i in range(1, n_patients + 1)]
    n_train = max(1, int(n_patients * 0.6))
    n_val = max(1, int(n_patients * 0.2))
    splits = {
        "train": patients[:n_train],
        "val": patients[n_train:n_train + n_val],
        "test": patients[n_train + n_val:] or patients[-1:],
    }
    folds = Node({split: np.array(ids, dtype="S") for split, ids in splits.items()})
    tree = Node({"cross_validation": Node({f"fold_{fold}": folds})},
                attrs={"register": False, "sequence": False})
    for pid in patients:
        views = Node()
        for view in ("2CH", "4CH"):
            frames = [make_sample(rng, k, size) for _ in range(2)]
            views.members[view] = Node(
                {"img_proc": np.stack([f[0] for f in frames]),
                 "gt_proc": np.stack([f[1] for f in frames])},
                attrs={"voxelspacing": np.array([1.0, 0.62, 0.42]),
                       "instants": np.array(["ED", "ES"], dtype="S"),
                       "ED": 0, "ES": 1, "ImageQuality": "Good"})
        tree.members[pid] = views
    return tree
