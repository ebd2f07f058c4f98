"""Raw data -> HDF5 dataset generators (CAMUS echocardiography, JSRT chest
X-ray).

The port's own copy of contouring_uncertainty_tpu/data/generators.py
(host code, numpy):

- `read_mhd` / `write_mhd`: a MetaImage (.mhd + raw/zraw) reader and
  writer for the subset CAMUS uses (MET_UCHAR/CHAR/USHORT/SHORT/UINT/INT/
  FLOAT/DOUBLE, optional zlib compression, optional big-endian data);
- `_resize`: PIL bilinear, nearest or bicubic (PIL's default filter);
- `generate_camus`: the raw CAMUS download (patients' half-cycle MHD
  sequences, Info_{2CH,4CH}.cfg, listSubGroups/ fold lists) -> the
  cross-validation HDF5 the CAMUS readers take: ED before ES (a sequence
  whose ES comes first is reversed and its instants mapped i -> n-1-i),
  the ED and ES frames or, with `sequence`, the whole sequence, images
  resized bilinearly and masks with nearest to `target_image_size`;
- `generate_jsrt`: the HybridGNet JSRT layout (raw big-endian 12-bit .IMG
  scans, landmark .npy files, split lists) -> the flat lung-landmark HDF5
  of data/lung.py, the label map rasterized from the first 120 landmarks.

h5py and PIL are imported only inside the functions that need them.

CLI: python -m contouring_uncertainty_torch.tools generate-camus /
generate-jsrt.
"""

from __future__ import annotations

import zlib
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

_MHD_DTYPES = {
    "MET_UCHAR": np.uint8,
    "MET_CHAR": np.int8,
    "MET_USHORT": np.dtype("<u2"),
    "MET_SHORT": np.dtype("<i2"),
    "MET_UINT": np.dtype("<u4"),
    "MET_INT": np.dtype("<i4"),
    "MET_FLOAT": np.dtype("<f4"),
    "MET_DOUBLE": np.dtype("<f8"),
}

IMG_SAVE_OPTIONS = {"dtype": np.float32, "compression": "gzip", "compression_opts": 4}
SEG_SAVE_OPTIONS = {"dtype": np.uint8, "compression": "gzip", "compression_opts": 4}


def read_mhd(path: Path) -> Tuple[np.ndarray, Tuple[float, ...]]:
    """Minimal MetaImage (.mhd + raw/zraw) reader.

    Returns (array of shape DimSize reversed (z, y, x), ElementSpacing (x, y, z)).
    """
    path = Path(path)
    header: Dict[str, str] = {}
    for line in path.read_text().splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            header[k.strip()] = v.strip()
    dims = [int(v) for v in header["DimSize"].split()]
    dtype = _MHD_DTYPES[header.get("ElementType", "MET_UCHAR")]
    spacing = tuple(float(v) for v in header.get(
        "ElementSpacing", " ".join(["1.0"] * len(dims))).split())
    data_file = header.get("ElementDataFile", "LOCAL")
    raw = (path.parent / data_file).read_bytes()
    if header.get("CompressedData", "False").lower() == "true":
        raw = zlib.decompress(raw)
    arr = np.frombuffer(raw, dtype=dtype)
    if header.get("ElementByteOrderMSB", "False").lower() == "true":
        arr = arr.byteswap()
    return arr.reshape(dims[::-1]).copy(), spacing


def write_mhd(path: Path, array: np.ndarray, spacing=(1.0, 1.0, 1.0),
              element_type: str = "MET_UCHAR", compressed: bool = False) -> None:
    """The reader's companion writer; array shape (z, y, x)."""
    path = Path(path)
    dtype = _MHD_DTYPES[element_type]
    raw = np.ascontiguousarray(array.astype(dtype)).tobytes()
    if compressed:
        raw = zlib.compress(raw)
        data_name = path.with_suffix(".zraw").name
    else:
        data_name = path.with_suffix(".raw").name
    dims = " ".join(str(d) for d in array.shape[::-1])
    sp = " ".join(str(s) for s in spacing[:array.ndim])
    path.write_text(
        "ObjectType = Image\n"
        f"NDims = {array.ndim}\n"
        f"DimSize = {dims}\n"
        f"ElementType = {element_type}\n"
        f"ElementSpacing = {sp}\n"
        f"CompressedData = {compressed}\n"
        f"ElementDataFile = {data_name}\n"
    )
    (path.parent / data_name).write_bytes(raw)


def _resize(image: np.ndarray, size: Tuple[int, int], bilinear: bool,
            bicubic: bool = False) -> np.ndarray:
    """PIL resize to `size` = (H, W): BILINEAR (`bilinear`) or NEAREST, or
    with `bicubic` PIL's default BICUBIC filter (the JSRT generator's)."""
    from PIL import Image

    if bicubic:
        resample = Image.Resampling.BICUBIC
    elif bilinear:
        resample = Image.Resampling.BILINEAR
    else:
        resample = Image.Resampling.NEAREST
    h, w = size
    return np.array(Image.fromarray(image).resize((w, h), resample=resample))


def generate_camus(
    data_dir: str | Path,
    output: str | Path,
    folds: Sequence[int] = tuple(range(1, 11)),
    target_image_size: Tuple[int, int] = (256, 256),
    sequence: bool = False,
    labels_to_keep: Optional[Sequence[int]] = None,
    img_format: str = "mhd",
    decoder: Optional[Callable[[Path], Tuple[np.ndarray, Tuple[float, ...]]]] = None,
) -> None:
    """Build the cross-validation CAMUS HDF5 from the raw download layout:

        {data_dir}/listSubGroups/subGroup{fold}_{training,validation,testing}.txt
        {data_dir}/{patient}/Info_{2CH,4CH}.cfg
        {data_dir}/{patient}/{patient}_{view}_half_sequence[_gt].mhd

    Per view: the half-cycle sequence and its masks, the ED/ES frame
    indices of the info file (1-based there, 0-based in the HDF5), the
    sequence reversed when ES precedes ED, the key instants (or the whole
    sequence), images resized bilinearly and masks with nearest to
    `target_image_size`; written as img_proc/gt/gt_proc with voxelspacing
    and instants (and ImageQuality where the info file has it) as
    attributes. `decoder` reads another format (`img_format=npy`: numpy
    files with unit spacing).
    """
    import h5py

    data_dir, output = Path(data_dir), Path(output)
    if decoder is None:
        if img_format == "mhd":
            decoder = read_mhd
        elif img_format == "npy":
            def decoder(p: Path):
                return np.load(p), (1.0, 1.0, 1.0)
        else:
            raise ValueError(f"no decoder for img_format={img_format!r}; pass one")

    subset_names = {"train": "training", "val": "validation", "test": "testing"}

    def fold_subset(fold: int, subset_in_data: str):
        fn = data_dir / "listSubGroups" / f"subGroup{fold}_{subset_in_data}.txt"
        return [ln for ln in fn.read_text().splitlines() if ln.strip()]

    output.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(output, "w") as f:
        f.attrs["full_sequence"] = sequence
        f.attrs["register"] = False
        cv = f.create_group("cross_validation")
        patient_ids: set = set()
        for fold in folds:
            g = cv.create_group(f"fold_{fold}")
            for subset, name_in_data in subset_names.items():
                pats = fold_subset(fold, name_in_data)
                g.create_dataset(subset, data=np.array(pats, dtype="S"))
                patient_ids.update(pats)

        for pid in sorted(patient_ids):
            pdir = data_dir / pid
            pgroup = f.create_group(pid)
            for view in ("2CH", "4CH"):
                info_fn = pdir / f"Info_{view}.cfg"
                if not info_fn.exists():
                    continue
                info = {}
                for line in info_fn.read_text().splitlines():
                    if ":" in line:
                        k, v = line.split(":", 1)
                        info[k.strip()] = v.strip()
                instants = {"ED": int(info["ED"]) - 1, "ES": int(info["ES"]) - 1}

                seq, spacing = decoder(
                    pdir / f"{pid}_{view}_half_sequence.{img_format}")
                seq_gt, _ = decoder(
                    pdir / f"{pid}_{view}_half_sequence_gt.{img_format}")
                seq = np.asarray(seq)
                seq_gt = np.asarray(seq_gt)
                if seq.ndim == 2:
                    seq, seq_gt = seq[None], seq_gt[None]

                # Chronological order: ED before ES.
                if instants["ED"] > instants["ES"]:
                    seq = seq[::-1]
                    seq_gt = seq_gt[::-1]
                    n = len(seq)
                    instants = {"ED": n - 1 - instants["ED"],
                                "ES": n - 1 - instants["ES"]}

                if labels_to_keep is not None:
                    keep = set(int(l) for l in labels_to_keep)
                    seq_gt = np.where(np.isin(seq_gt, list(keep)), seq_gt, 0)

                if sequence:
                    data_x, data_y = seq, seq_gt
                else:
                    order = ["ED", "ES"]
                    data_x = np.stack([seq[instants[k]] for k in order])
                    data_y = np.stack([seq_gt[instants[k]] for k in order])
                    instants = {k: i for i, k in enumerate(order)}

                h, w = target_image_size
                img_proc = np.stack(
                    [_resize(fr.astype(np.float32), (h, w), True) for fr in data_x]
                )
                gt_proc = np.stack(
                    [_resize(fr.astype(np.uint8), (h, w), False) for fr in data_y]
                )

                vg = pgroup.create_group(view)
                vg.create_dataset("img_proc", data=img_proc[..., None],
                                  **IMG_SAVE_OPTIONS)
                vg.create_dataset("gt", data=data_y, **SEG_SAVE_OPTIONS)
                vg.create_dataset("gt_proc", data=gt_proc, **SEG_SAVE_OPTIONS)
                vg.attrs["voxelspacing"] = np.asarray(spacing[::-1], np.float32)
                vg.attrs["instants"] = list(instants)
                for k, idx in instants.items():
                    vg.attrs[k] = idx
                if "ImageQuality" in info:
                    vg.attrs["ImageQuality"] = info["ImageQuality"]


def generate_jsrt(
    data_dir: str | Path,
    output: str | Path,
    target_image_size: Tuple[int, int] = (256, 256),
    original_img_shape: Tuple[int, int] = (2048, 2048),
) -> None:
    """Build the lung-landmark HDF5 from the HybridGNet-JSRT layout:

        {data_dir}/{train,val,test}_files.txt        (one '{id}.IMG' per line)
        {data_dir}/{Train,Val,Test}/landmarks/{id}.npy  (landmarks, (N, 2))
        {data_dir}/All247images/{id}.IMG             (raw big-endian uint16)

    Per scan: invert + scale the raw intensities ((1 - img/4096) * 255),
    resize to 1024 then to `target_image_size` (BICUBIC) with the landmarks
    rescaled, keep the first 44+50+26 landmarks (right lung, left lung,
    heart) and rasterize them into the label map (`lung_contour_to_mask`).
    """
    import h5py

    from contouring_uncertainty_torch.data.lung import N_POINTS, lung_contour_to_mask

    data_dir, output = Path(data_dir), Path(output)
    splits = {"train": "Train", "val": "Val", "test": "Test"}

    with h5py.File(output, "w") as f:
        for split, cap in splits.items():
            ids = [
                ln.strip().replace(".IMG", "")
                for ln in (data_dir / f"{split}_files.txt").read_text().splitlines()
                if ln.strip()
            ]
            landmark_dir = data_dir / cap / "landmarks"
            sg = f.create_group(split)
            for item_id in ids:
                img_file = data_dir / "All247images" / f"{item_id}.IMG"
                if not img_file.exists():
                    continue
                raw = np.frombuffer(img_file.read_bytes(), np.dtype(">u2"))
                img = raw.reshape(original_img_shape).astype(np.float64)
                img = (1.0 - img / 4096.0) * 255.0
                img = _resize(img, (1024, 1024), True, bicubic=True)

                landmarks = np.load(landmark_dir / f"{item_id}.npy")
                landmarks = landmarks.astype(np.float64).reshape(-1, 2)

                h, w = target_image_size
                scale_y = h / img.shape[0]
                scale_x = w / img.shape[1]
                img = _resize(img, (h, w), True, bicubic=True)
                landmarks = landmarks.copy()
                landmarks[..., 1] *= scale_y
                landmarks[..., 0] *= scale_x

                landmarks = landmarks[:N_POINTS]
                gt = lung_contour_to_mask(landmarks, (h, w))

                g = sg.create_group(item_id)
                g.create_dataset("img", data=img, **IMG_SAVE_OPTIONS)
                g.create_dataset("gt", data=gt, **SEG_SAVE_OPTIONS)
                g.create_dataset("contour", data=landmarks.astype(np.float32))
