"""CAMUS-layout data: label masks, images and landmark contours, from HDF5
or from memory.

The port's own copy of contouring_uncertainty_tpu/data/camus.py. The layout

    /cross_validation/fold_{f}/{train,val,test}   -> patient id lists
    /{patient}/{view}/img_proc  (N, H, W) float32 (or (N, H, W, 1), or 0..255)
    /{patient}/{view}/gt_proc   (N, H, W) uint8
    view attrs: voxelspacing, instants, one attr per instant, ImageQuality

is read once per split into host numpy arrays. Landmark contours are
extracted from the label masks (data/contour_extraction.py) and cached
beside the file in a `.npz` keyed by file name, fold, split, points and
labels: the same file name and keys as the JAX package, so a cache either
package writes is read by the other.

`CamusContourData.from_arrays` reads the same layout from memory (a
`Group` tree, as `data/synthetic.py make_camus_tree` draws it), which is how
a machine without h5py is fed; it caches nothing. h5py is imported only
inside `_split_patients` and `load_split`.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from contouring_uncertainty_torch.data.config import DataParams, Label, Tags
from contouring_uncertainty_torch.data.contour_extraction import get_contour_points


@dataclass
class Group:
    """An HDF5 group in memory: members (groups or arrays) addressed by
    "a/b" paths, and attrs, as h5py reads them."""

    members: Dict[str, Any] = field(default_factory=dict)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def __getitem__(self, path: str):
        node = self
        for part in path.split("/"):
            node = node.members[part]
        return node

    def __contains__(self, name: str) -> bool:
        return name in self.members

    def keys(self):
        return self.members.keys()


@dataclass
class ViewData:
    id: str
    img: np.ndarray  # (N, 1, H, W) float32
    gt: np.ndarray  # (N, H, W) uint8
    contour: np.ndarray  # (N, K, 2) float32
    voxelspacing: np.ndarray
    instants: Dict[str, int]
    image_quality: str = "Unknown"


def _image_quality(group) -> str:
    """ImageQuality metadata, a view attr or a dataset inside the view group."""
    if "ImageQuality" in group.attrs:
        v = group.attrs["ImageQuality"]
    elif "ImageQuality" in group:
        v = group["ImageQuality"][()]
    else:
        return "Unknown"
    return v.decode() if isinstance(v, bytes) else str(v)


class CamusContourData:
    """A CAMUS-layout file (or `from_arrays` tree) in memory, with its
    landmark contours: `train_arrays`, `predict_views`, `data_params` and
    `contour_groups`. `transform` (data/transforms.py) is applied once to
    each view's image stack at load time; `use_sequence` trains on every
    frame of a view instead of its key instants."""

    def __init__(
        self,
        dataset_path,
        fold: int = 5,
        points_per_side: int = 11,
        labels: Sequence[Label] = (Label.BG, Label.LV),
        cache_dir: Optional[Path] = None,
        use_sequence: bool = False,
        transform=None,
    ):
        self.path = Path(dataset_path) if dataset_path is not None else None
        self.transform = transform
        self.fold = fold
        self.points_per_side = points_per_side
        self.labels = tuple(labels)
        self.use_sequence = use_sequence
        self._include_myo = Label.MYO in self.labels
        self.nb_points = 2 * points_per_side - 1
        self._cache_dir = Path(cache_dir) if cache_dir else (
            self.path.parent if self.path is not None else None)
        self._tree: Optional[Group] = None
        self._views: Dict[str, Dict[str, ViewData]] = {}

    @classmethod
    def from_arrays(cls, tree: Group, **kwargs) -> "CamusContourData":
        """A source over an in-memory CAMUS-layout `tree`, read as the HDF5
        file would be (keyword arguments as the constructor's, without a
        path); its contours are extracted and not cached."""
        data = cls(None, **kwargs)
        data._tree = tree
        return data

    # ------------------------------------------------------------------ loading

    def _patients(self, f, split: str) -> List[str]:
        return [p.decode() if isinstance(p, bytes) else str(p)
                for p in f[f"cross_validation/fold_{self.fold}/{split}"]]

    def _split_patients(self, split: str) -> List[str]:
        if self._tree is not None:
            return self._patients(self._tree, split)
        import h5py

        with h5py.File(self.path, "r") as f:
            return self._patients(f, split)

    def _cache_path(self, split: str) -> Optional[Path]:
        if self._tree is not None:
            return None
        key = (f"{self.path.name}-{self.fold}-{split}-{self.points_per_side}-"
               f"{len(self.labels)}-{self._include_myo}")
        digest = hashlib.md5(key.encode()).hexdigest()[:10]
        return self._cache_dir / f"contours_{split}_{digest}.npz"

    def _read_views(self, f, patients: List[str], cached: Dict,
                    new_cache: Dict) -> Dict[str, ViewData]:
        views: Dict[str, ViewData] = {}
        for pid in patients:
            for view in f[pid].keys():
                g = f[f"{pid}/{view}"]
                img = np.asarray(g["img_proc"], np.float32)
                if img.ndim == 4 and img.shape[-1] == 1:
                    # a trailing channel axis, as the reference's generator writes
                    img = img[..., 0]
                if img.max() > 1.5:  # raw grayscale datasets store 0..255
                    img = img / 255.0
                if self.transform is not None:
                    img = np.asarray(self.transform(img), np.float32)
                gt = np.asarray(g["gt_proc"], np.uint8)
                vid = f"{pid}/{view}"
                ckey = vid.replace("/", "_")
                if ckey in cached:
                    contour = cached[ckey]
                else:
                    contour = np.stack([
                        get_contour_points(gt[i], self.nb_points,
                                           include_myo=self._include_myo)
                        for i in range(len(gt))
                    ])
                new_cache[ckey] = contour
                instants = {}
                for ikey in g.attrs.get("instants", []):
                    ikey = ikey.decode() if isinstance(ikey, bytes) else str(ikey)
                    instants[ikey] = int(g.attrs[ikey])
                views[vid] = ViewData(
                    id=vid,
                    img=img[:, None],
                    gt=gt,
                    contour=contour,
                    voxelspacing=np.asarray(g.attrs.get("voxelspacing", [1.0, 1.0, 1.0])),
                    instants=instants or {"ED": 0, "ES": min(1, len(gt) - 1)},
                    image_quality=_image_quality(g),
                )
        return views

    def load_split(self, split: str) -> List[ViewData]:
        if split in self._views:
            return list(self._views[split].values())

        patients = self._split_patients(split)
        cache_file = self._cache_path(split)
        cached = (dict(np.load(cache_file, allow_pickle=False))
                  if cache_file is not None and cache_file.exists() else {})
        new_cache: Dict[str, np.ndarray] = {}
        if self._tree is not None:
            views = self._read_views(self._tree, patients, cached, new_cache)
        else:
            import h5py

            with h5py.File(self.path, "r") as f:
                views = self._read_views(f, patients, cached, new_cache)
        if cache_file is not None and new_cache.keys() - cached.keys():
            np.savez_compressed(cache_file, **{**cached, **new_cache})
        self._views[split] = views
        return list(views.values())

    # ----------------------------------------------------------------- batching

    def train_arrays(self, split: str = "train") -> Dict[str, np.ndarray]:
        """Every training frame of the split in flat arrays: the key instants
        of each view, or with `use_sequence` all of its frames."""
        views = self.load_split(split)
        imgs, gts, contours, ids = [], [], [], []
        for v in views:
            if self.use_sequence or not v.instants:
                frames = range(v.img.shape[0])
            else:
                frames = sorted(set(v.instants.values()))
            for i in frames:
                imgs.append(v.img[i])
                gts.append(v.gt[i])
                contours.append(v.contour[i])
                ids.append(f"{v.id}_{i}")
        return {
            Tags.img: np.stack(imgs),
            Tags.gt: np.stack(gts),
            Tags.contour: np.stack(contours),
            Tags.id: np.array(ids),
        }

    def predict_views(self, split: str = "test") -> Iterator[Dict]:
        """Whole-view prediction items (all frames of one patient view)."""
        for v in self.load_split(split):
            yield {
                Tags.id: v.id,
                Tags.img: v.img,
                Tags.gt: v.gt,
                Tags.contour: v.contour,
                Tags.voxelspacing: v.voxelspacing,
                Tags.instants: v.instants,
                Tags.image_quality: v.image_quality,
            }

    @property
    def contour_groups(self):
        """(start, end, label) landmark slices for the predict pipeline, in
        painting order: the epicardium's fill contains the LV cavity, so the
        MYO comes first and the LV last."""
        k = self.nb_points
        if self._include_myo:
            return ((k, 2 * k, int(Label.MYO)), (0, k, int(Label.LV)))
        return ((0, k, int(Label.LV)),)

    @property
    def data_params(self) -> DataParams:
        views = self.load_split("train")
        h, w = views[0].img.shape[-2:]
        # K from the extracted contours: nb_points, or 2 * nb_points with MYO.
        nb_points = views[0].contour.shape[1]
        return DataParams(in_shape=(1, h, w), out_shape=(nb_points, 2), labels=self.labels)


def iterate_batches(
    arrays: Dict[str, np.ndarray],
    batch_size: int,
    rng: np.random.Generator,
    shuffle: bool = True,
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Epoch iterator over stacked arrays (host side)."""
    n = len(arrays[Tags.img])
    order = rng.permutation(n) if shuffle else np.arange(n)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        idx = order[start:start + batch_size]
        yield {k: v[idx] for k, v in arrays.items()}
