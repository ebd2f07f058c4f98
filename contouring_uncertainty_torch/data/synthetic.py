"""Synthetic echo-like data (no matplotlib; h5py only inside the writer).

Counterpart of contouring_uncertainty_tpu/data/synthetic.py: the contour,
image and label generators, ported draw for draw, and `write_camus_hdf5`.
The films it writes are also built in memory (`make_camus_tree`), which
`synthetic_camus_data` reads through `data/camus.py
CamusContourData.from_arrays` with the landmarks extracted from the label
masks, as the JAX package reads its file back.

Difference from the JAX module: the polygon fill is a numpy even-odd test
at pixel centres instead of matplotlib's `Path.contains_points`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from contouring_uncertainty_torch.data.camus import CamusContourData, Group
from contouring_uncertainty_torch.data.config import Label


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


def make_camus_tree(n_patients: int = 8, k: int = 21, size: int = 256, seed: int = 0,
                    fold: int = 5) -> Group:
    """The CAMUS-layout file the JAX package's `write_camus_hdf5` writes for
    the same arguments, as an in-memory `Group` tree, drawn in its order:
    `n_patients` patients split 60/20/20 (at least one each), a 2CH and a
    4CH view of two frames (ED, ES) per patient."""
    rng = np.random.default_rng(seed)
    patients = [f"patient{i:04d}" for i in range(1, n_patients + 1)]
    n_train = max(1, int(n_patients * 0.6))
    n_val = max(1, int(n_patients * 0.2))
    splits = {
        "train": patients[:n_train],
        "val": patients[n_train:n_train + n_val],
        "test": patients[n_train + n_val:] or patients[-1:],
    }
    folds = Group({split: np.array(ids, dtype="S") for split, ids in splits.items()})
    tree = Group({"cross_validation": Group({f"fold_{fold}": folds})},
                 attrs={"register": False, "sequence": False})
    for pid in patients:
        views = Group()
        for view in ("2CH", "4CH"):
            frames = [make_sample(rng, k, size) for _ in range(2)]  # ED, ES
            views.members[view] = Group(
                {"img_proc": np.stack([f[0] for f in frames]),
                 "gt_proc": np.stack([f[1] for f in frames])},
                attrs={"voxelspacing": np.array([1.0, 0.62, 0.42]),
                       "instants": np.array(["ED", "ES"], dtype="S"),
                       "ED": 0, "ES": 1, "ImageQuality": "Good"})
        tree.members[pid] = views
    return tree


def write_camus_hdf5(path, n_patients: int = 8, k: int = 21, size: int = 256,
                     seed: int = 0, fold: int = 5) -> Path:
    """`make_camus_tree` written as a CAMUS-layout HDF5 file."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def write(h5, group: Group):
        h5.attrs.update(group.attrs)
        for name, member in group.members.items():
            if isinstance(member, Group):
                write(h5.create_group(name), member)
            else:
                h5.create_dataset(name, data=member)

    with h5py.File(path, "w") as f:
        write(f, make_camus_tree(n_patients, k, size, seed, fold))
    return path


def synthetic_camus_data(n_patients: int = 8, size: int = 256, seed: int = 0, fold: int = 5,
                         k: int = 21, **kwargs) -> CamusContourData:
    """The `data=synthetic` source: the films of `make_camus_tree` read from
    memory by `CamusContourData` (keyword arguments as its constructor's),
    the landmarks extracted from the label masks."""
    return CamusContourData.from_arrays(
        make_camus_tree(n_patients=n_patients, k=k, size=size, seed=seed, fold=fold),
        fold=fold, **kwargs)
