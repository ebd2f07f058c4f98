"""Synthetic echo-like data, in memory (no h5py, no matplotlib).

Counterpart of contouring_uncertainty_tpu/data/synthetic.py (contour, image
and label generators, ported draw for draw) plus an in-memory data source
exposing what `predict.run_predict` uses of the JAX package's
`data/camus.py CamusContourData`: `predict_views`, `train_arrays`,
`data_params` and `contour_groups`.

Differences from the JAX module: the polygon fill is a numpy even-odd test
at pixel centres instead of matplotlib's `Path.contains_points`, and the
landmark contours are the generating contours themselves (the HDF5 reader
re-extracts them from the label masks).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

from contouring_uncertainty_torch.data.config import DataParams, Label, Tags


def lv_contour_points(
    rng: np.random.Generator, k: int = 21, size: int = 256
) -> np.ndarray:
    """Random anatomically-plausible LV endocardium contour, (K, 2) in (x, y).

    Points run base1 -> apex -> base2 (the reference's landmark ordering from
    extract_points.py: base, side wall, apex, other wall, base).
    """
    s = size / 256.0
    cx = size / 2 + rng.uniform(-15, 15) * s
    base_y = size * 0.75 + rng.uniform(-15, 15) * s
    apex_y = size * 0.2 + rng.uniform(-10, 15) * s
    half_w = size * 0.18 + rng.uniform(-8, 12) * s
    tilt = rng.uniform(-0.15, 0.15)

    # Angles from 0 (base right) through pi (base left) over the half-ellipse.
    t = np.linspace(0.0, np.pi, k)
    x = cx + half_w * np.cos(t)
    height = base_y - apex_y
    y = base_y - height * np.sin(t) ** 0.9
    # Mild wall irregularity.
    wobble = rng.normal(scale=1.5 * s, size=k)
    x = x + wobble * np.sin(t)
    # Tilt around the base center.
    xr = cx + (x - cx) * np.cos(tilt) - (y - base_y) * np.sin(tilt)
    yr = base_y + (x - cx) * np.sin(tilt) + (y - base_y) * np.cos(tilt)
    pts = np.stack([xr, yr], axis=-1)
    # Reverse so the contour runs left-base -> apex -> right-base like CAMUS.
    return pts[::-1].astype(np.float32)


def _fill_poly(points: np.ndarray, size: int) -> np.ndarray:
    """Even-odd fill of the closed polygon `points` (P, 2) at pixel centres
    (x = column, y = row): a pixel is inside iff a ray to +x crosses an odd
    number of edges."""
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


def make_sample(
    rng: np.random.Generator, k: int = 21, size: int = 256
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (img (H, W) f32 in [0,1], gt (H, W) uint8 labels, contour (K, 2))."""
    contour = lv_contour_points(rng, k, size)
    lv = _fill_poly(contour, size)

    # Myocardium: dilated LV ring (coarse outward offset of the contour),
    # clipped above the base line so the LV base borders "atrium" (background)
    # like in CAMUS.
    center = contour.mean(axis=0)
    ring_pts = center + (contour - center) * 1.25
    myo = _fill_poly(ring_pts, size) & ~lv
    base_y = min(contour[0, 1], contour[-1, 1])
    yy_grid = np.arange(size)[:, None]
    myo &= yy_grid <= base_y

    gt = np.zeros((size, size), np.uint8)
    gt[myo] = int(Label.MYO)
    gt[lv] = int(Label.LV)

    speckle = rng.gamma(2.0, 0.25, size=(size, size))
    img = 0.45 * speckle
    img = np.where(lv, img * 0.35, img)  # anechoic cavity
    img = np.where(myo, img * 1.6, img)  # bright myocardium
    # Smooth a little to fake PSF.
    kernel = np.ones((3, 3)) / 9.0
    from scipy.signal import convolve2d

    img = convolve2d(img, kernel, mode="same", boundary="symm")
    return np.clip(img, 0, 1).astype(np.float32), gt, contour


def make_arrays(n: int, k: int = 21, size: int = 256, seed: int = 0):
    """In-memory dataset: img (N,1,H,W), gt (N,H,W), contour (N,K,2)."""
    rng = np.random.default_rng(seed)
    imgs, gts, contours = [], [], []
    for _ in range(n):
        img, gt, c = make_sample(rng, k, size)
        imgs.append(img[None])
        gts.append(gt)
        contours.append(c)
    return np.stack(imgs), np.stack(gts), np.stack(contours)


class SyntheticContourData:
    """In-memory CAMUS-like contour data: `n_patients` patients with a 2CH
    and a 4CH view of two frames (ED, ES) each, split train/val/test by the
    same rule and drawn in the same order as the JAX package's
    `write_camus_hdf5`. Single contour group: the LV, label 1."""

    def __init__(self, n_patients: int = 8, k: int = 21, size: int = 256,
                 seed: int = 0):
        self.k = k
        self.size = size
        rng = np.random.default_rng(seed)
        patients = [f"patient{i:04d}" for i in range(1, n_patients + 1)]
        n_train = max(1, int(n_patients * 0.6))
        n_val = max(1, int(n_patients * 0.2))
        self._splits = {
            "train": patients[:n_train],
            "val": patients[n_train:n_train + n_val],
            "test": patients[n_train + n_val:] or patients[-1:],
        }
        self._views: Dict[str, Dict] = {}
        for pid in patients:
            for view in ("2CH", "4CH"):
                frames = [make_sample(rng, k, size) for _ in range(2)]  # ED, ES
                self._views[f"{pid}/{view}"] = {
                    Tags.id: f"{pid}/{view}",
                    Tags.img: np.stack([f[0] for f in frames])[:, None],
                    Tags.gt: np.stack([f[1] for f in frames]),
                    Tags.contour: np.stack([f[2] for f in frames]),
                    Tags.voxelspacing: np.array([1.0, 0.62, 0.42]),
                    Tags.instants: {"ED": 0, "ES": 1},
                    Tags.image_quality: "Good",
                }

    def _split_views(self, split: str) -> List[Dict]:
        return [v for vid, v in self._views.items()
                if vid.split("/")[0] in self._splits[split]]

    def predict_views(self, split: str = "test") -> Iterator[Dict]:
        """Whole-view prediction items (all frames of one patient view)."""
        for v in self._split_views(split):
            yield dict(v)

    def train_arrays(self, split: str = "train") -> Dict[str, np.ndarray]:
        """Every frame of the split stacked into flat arrays."""
        views = self._split_views(split)
        return {
            Tags.img: np.concatenate([v[Tags.img] for v in views]),
            Tags.gt: np.concatenate([v[Tags.gt] for v in views]),
            Tags.contour: np.concatenate([v[Tags.contour] for v in views]),
            Tags.id: np.array([f"{v[Tags.id]}_{i}" for v in views
                               for i in range(len(v[Tags.img]))]),
        }

    @property
    def data_params(self) -> DataParams:
        return DataParams(in_shape=(1, self.size, self.size),
                          out_shape=(self.k, 2), labels=(Label.BG, Label.LV))

    @property
    def contour_groups(self):
        """(start, end, label) landmark slices for the predict pipeline."""
        return ((0, self.k, int(Label.LV)),)
