"""JSRT chest X-ray landmark data (lungs and heart), in memory or from HDF5.

The port's own copy of contouring_uncertainty_tpu/data/lung.py. The flat
HDF5 layout

    /{train,val,test}/{id}/{img (H, W), gt (H, W), contour (120, 2)}

holds 120 landmarks per film: right lung 44, left lung 50, heart 26. Both
lungs carry `LungLabel.LUNG` (1), the heart `LungLabel.HEART` (2), and
where a lung and the heart overlap the lung wins.

Differences from the JAX module: `lung_contour_to_mask` is a numpy f64
even-odd test with matplotlib's crossing predicate instead of
`matplotlib.path.Path.contains_points` (the same pixels); the generator is
split into `make_jsrt_arrays` (the same draws in the same order as
`write_jsrt_hdf5`) and the writer; and `JSRTContourData.from_arrays`
fills the reader's cache from arrays, which is how a machine without
h5py is fed. h5py is imported only inside the reader's `_load` and inside
`write_jsrt_hdf5`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from contouring_uncertainty_torch.data.config import DataParams, LungLabel, Tags

RLUNG, LLUNG, HEART = 44, 50, 26
# (name, start, end, label) of each structure's landmark slice.
STRUCTURES = (("rlung", 0, RLUNG, int(LungLabel.LUNG)),
              ("llung", RLUNG, RLUNG + LLUNG, int(LungLabel.LUNG)),
              ("heart", RLUNG + LLUNG, RLUNG + LLUNG + HEART, int(LungLabel.HEART)))
N_POINTS = RLUNG + LLUNG + HEART


def split_structures(contour: np.ndarray) -> Dict[str, np.ndarray]:
    return {name: contour[a:b] for name, a, b, _ in STRUCTURES}


def inside_polygon(vertices: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Even-odd test of every pixel (x = column, y = row, integer
    coordinates) against the closed polygon `vertices` (P, 2), in f64 with
    matplotlib's crossing predicate: an edge (x0, y0) -> (x1, y1) counts
    for a pixel (tx, ty) when (y0 >= ty) != (y1 >= ty) and
    ((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == (y1 >= ty).
    Each edge is tested on the rows it spans only."""
    h, w = shape
    p0 = vertices.astype(np.float64)
    p1 = np.roll(p0, -1, axis=0)
    tx = np.arange(w, dtype=np.float64)
    inside = np.zeros((h, w), bool)
    for (x0, y0), (x1, y1) in zip(p0, p1):
        # (y0 >= ty) != (y1 >= ty) holds for min(y0, y1) < ty <= max(y0, y1).
        lo = max(int(np.floor(min(y0, y1))) + 1, 0)
        hi = min(int(np.floor(max(y0, y1))), h - 1)
        if lo > hi:
            continue
        ty = np.arange(lo, hi + 1, dtype=np.float64)[:, None]
        y1_above = y1 >= ty
        crosses = ((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == y1_above
        inside[lo:hi + 1] ^= crosses
    return inside


def lung_contour_to_mask(contour: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Rasterize the three structures of a (120, 2) contour into a uint8
    label map, painting in descending label order so the lungs overwrite
    the heart where they overlap."""
    out = np.zeros(shape, np.uint8)
    for _, a, b, label in sorted(STRUCTURES, key=lambda s: -s[3]):
        out[inside_polygon(contour[a:b], shape)] = label
    return out


class JSRTContourData:
    """JSRT films with the API of the port's other data sources:
    `train_arrays`, `predict_views` (one frame per film), `data_params` and
    `contour_groups`. Read from `dataset_path` (h5py, once per split), or
    built by `from_arrays`. `transform` is applied once to each image."""

    def __init__(self, dataset_path, labels: Sequence[LungLabel] = (
            LungLabel.BG, LungLabel.LUNG, LungLabel.HEART),
            transform: Optional[Callable] = None):
        self.path = Path(dataset_path)
        self.labels = tuple(labels)
        self.transform = transform
        self._cache: Dict[str, Dict[str, np.ndarray]] = {}

    @classmethod
    def from_arrays(cls, splits: Dict[str, Dict[str, np.ndarray]],
                    labels: Sequence[LungLabel] = (LungLabel.BG, LungLabel.LUNG,
                                                   LungLabel.HEART),
                    transform: Optional[Callable] = None) -> "JSRTContourData":
        """A source over in-memory splits, split -> {"img" (n, H, W), "gt"
        (n, H, W), "contour" (n, 120, 2), "id" (n,)} as `make_jsrt_arrays`
        returns them, read as the HDF5 reader reads the file's items."""
        data = cls("", labels=labels, transform=transform)
        for split, arrays in splits.items():
            data._cache[split] = data._stack(
                arrays[Tags.img], arrays[Tags.gt], arrays[Tags.contour], arrays[Tags.id])
        return data

    def _stack(self, imgs, gts, contours, ids) -> Dict[str, np.ndarray]:
        out = []
        for img in imgs:
            img = np.asarray(img, np.float32)
            if img.max() > 1.5:
                img = img / 255.0
            if self.transform is not None:
                img = np.asarray(self.transform(img), np.float32)
            out.append(img[None])
        return {Tags.img: np.stack(out),
                Tags.gt: np.stack([np.asarray(g, np.uint8) for g in gts]),
                Tags.contour: np.stack([np.asarray(c, np.float32) for c in contours]),
                Tags.id: np.array([str(i) for i in ids])}

    def _load(self, split: str) -> Dict[str, np.ndarray]:
        if split in self._cache:
            return self._cache[split]
        import h5py

        with h5py.File(self.path, "r") as f:
            ids = list(f[split])
            items = [f[f"{split}/{i}"] for i in ids]
            self._cache[split] = self._stack(
                [np.asarray(g["img"]) for g in items], [np.asarray(g["gt"]) for g in items],
                [np.asarray(g["contour"]) for g in items], ids)
        return self._cache[split]

    def train_arrays(self, split: str = "train") -> Dict[str, np.ndarray]:
        return self._load(split)

    def predict_views(self, split: str = "test") -> Iterator[Dict]:
        data = self._load(split)
        for i in range(len(data[Tags.img])):
            yield {
                Tags.id: str(data[Tags.id][i]),
                Tags.img: data[Tags.img][i:i + 1],
                Tags.gt: data[Tags.gt][i:i + 1],
                Tags.contour: data[Tags.contour][i:i + 1],
                Tags.voxelspacing: np.array([1.0, 1.0, 1.0]),
                Tags.instants: {"ED": 0},
            }

    @property
    def contour_groups(self):
        """(start, end, label) landmark slices of rlung, llung and heart; the
        predictor paints them in descending label order (lungs over heart)."""
        return tuple((a, b, label) for _, a, b, label in STRUCTURES)

    @property
    def data_params(self) -> DataParams:
        h, w = self._load("train")[Tags.img].shape[-2:]
        return DataParams(in_shape=(1, h, w), out_shape=(N_POINTS, 2), labels=self.labels)


def _structure_contour(rng, cx, cy, rx, ry, n):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    x = cx + rx * np.cos(t)
    y = cy + ry * np.sin(t)
    x += rng.normal(scale=0.5, size=n)
    y += rng.normal(scale=0.5, size=n)
    return np.stack([x, y], -1)


def make_jsrt_arrays(n_items: int = 12, size: int = 256,
                     seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """Synthetic JSRT-like films (lungs as tall ellipses, the heart between
    them), split -> {"img" (n, H, W) f32 in [0, 1], "gt" (n, H, W) uint8,
    "contour" (n, 120, 2) f32, "id" (n,)}: the films the JAX package's
    `write_jsrt_hdf5` writes for the same arguments, drawn in its order."""
    rng = np.random.default_rng(seed)
    s = size / 256.0
    n_train, n_val = int(n_items * 0.6) or 1, int(n_items * 0.2) or 1
    splits = {"train": n_train, "val": n_val, "test": n_items - n_train - n_val or 1}
    out, idx = {}, 0
    for split, count in splits.items():
        items = {Tags.img: [], Tags.gt: [], Tags.contour: [], Tags.id: []}
        for _ in range(count):
            rl = _structure_contour(rng, size * 0.32 + rng.uniform(-5, 5) * s,
                                    size * 0.45, size * 0.14, size * 0.3, RLUNG)
            ll = _structure_contour(rng, size * 0.68 + rng.uniform(-5, 5) * s,
                                    size * 0.45, size * 0.14, size * 0.3, LLUNG)
            he = _structure_contour(rng, size * 0.52, size * 0.62,
                                    size * 0.12, size * 0.14, HEART)
            contour = np.concatenate([rl, ll, he]).astype(np.float32)
            gt = lung_contour_to_mask(contour, (size, size))
            img = rng.gamma(2.0, 0.2, (size, size)).astype(np.float32)
            img = np.where(gt > 0, img * 0.5, img)
            items[Tags.img].append(np.clip(img, 0, 1))
            items[Tags.gt].append(gt)
            items[Tags.contour].append(contour)
            items[Tags.id].append(f"case{idx:04d}")
            idx += 1
        out[split] = {k: np.stack(v) if k != Tags.id else np.array(v) for k, v in items.items()}
    return out


def write_jsrt_hdf5(path, n_items: int = 12, size: int = 256, seed: int = 0) -> Path:
    """`make_jsrt_arrays` written in the JAX package's HDF5 layout."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        for split, arrays in make_jsrt_arrays(n_items, size, seed).items():
            for i, item_id in enumerate(arrays[Tags.id]):
                g = f.create_group(f"{split}/{item_id}")
                for key in (Tags.img, Tags.gt, Tags.contour):
                    g.create_dataset(key, data=arrays[key][i])
    return path
