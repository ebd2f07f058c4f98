"""Offline tools: shape-prior generation and the raw-data HDF5 generators.

Counterpart of contouring_uncertainty_tpu/tools.py:

    python -m contouring_uncertainty_torch.tools generate-psm data=camus-cont \\
        out=priors/camus-cont_psm_11.npz seq_out=priors/camus-cont_sequence_psm_11.npz
    python -m contouring_uncertainty_torch.tools generate-camus <raw_camus_dir> \\
        out=camus.h5 [folds=1,2,...] [sequence=true] [img_format=mhd] [labels=0,1]
    python -m contouring_uncertainty_torch.tools generate-jsrt <hybridnet_jsrt_dir> \\
        out=jsrt_contour.h5

`generate-psm` fits the single-instant prior on the training contours of
the composed data config (and, with `seq_out`, the two-instant prior on the
training views' (ED, ES) pairs) and writes each with the digest of the
contours it was fit on, so the runner's `get_or_fit_prior` and
`get_or_fit_sequence_prior` load it instead of refitting it.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

from contouring_uncertainty_torch.config import compose
from contouring_uncertainty_torch.data.config import Tags
from contouring_uncertainty_torch.factory import build_data
from contouring_uncertainty_torch.predict import contour_digest
from contouring_uncertainty_torch.sampler.prior import fit_shape_prior, save_prior


def generate_psm(overrides: Optional[List[str]] = None):
    overrides = list(overrides or [])
    out = "priors/psm.npz"
    seq_out = None
    rest = []
    for ov in overrides:
        if ov.startswith("out="):
            out = ov.split("=", 1)[1]
        elif ov.startswith("seq_out="):
            seq_out = ov.split("=", 1)[1]
        else:
            rest.append(ov)
    data = build_data(compose(rest))

    contours = np.asarray(data.train_arrays("train")[Tags.contour])
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    save_prior(Path(out), fit_shape_prior(contours), fit_digest=contour_digest(contours))
    print(f"single-instant prior ({contours.shape[1] * 2}-dim, "
          f"{len(contours)} shapes) -> {out}")

    if seq_out:
        # ED and ES contours of a view, stacked into one 2K-point shape.
        pairs = []
        for view in data.predict_views("train"):
            inst = view[Tags.instants]
            if "ED" in inst and "ES" in inst:
                c = view[Tags.contour]
                pairs.append(np.concatenate([c[inst["ED"]], c[inst["ES"]]]))
        if pairs:
            pairs = np.stack(pairs)
            Path(seq_out).parent.mkdir(parents=True, exist_ok=True)
            save_prior(Path(seq_out), fit_shape_prior(pairs), fit_digest=contour_digest(pairs))
            print(f"sequence prior ({pairs.shape[1] * 2}-dim, {len(pairs)} views) -> {seq_out}")


def generate_camus_cli(args: List[str]):
    from contouring_uncertainty_torch.data.generators import generate_camus

    data_dir, kw = None, {}
    for a in args:
        if "=" not in a:
            data_dir = a
        else:
            k, v = a.split("=", 1)
            if k == "out":
                kw["output"] = v
            elif k == "folds":
                kw["folds"] = [int(x) for x in v.split(",")]
            elif k == "sequence":
                kw["sequence"] = v.lower() in ("1", "true", "yes")
            elif k == "img_format":
                kw["img_format"] = v
            elif k == "labels":
                kw["labels_to_keep"] = [int(x) for x in v.split(",")]
            else:
                raise SystemExit(f"unknown option {a}")
    if data_dir is None:
        raise SystemExit("generate-camus needs the raw CAMUS directory")
    kw.setdefault("output", "camus.h5")
    generate_camus(data_dir, **kw)
    print(f"wrote {kw['output']}")


def generate_jsrt_cli(args: List[str]):
    from contouring_uncertainty_torch.data.generators import generate_jsrt

    data_dir, out = None, "jsrt_contour.h5"
    for a in args:
        if a.startswith("out="):
            out = a.split("=", 1)[1]
        else:
            data_dir = a
    if data_dir is None:
        raise SystemExit("generate-jsrt needs the hybridnet-jsrt directory")
    generate_jsrt(data_dir, out)
    print(f"wrote {out}")


COMMANDS = {
    "generate-psm": generate_psm,
    "generate-camus": generate_camus_cli,
    "generate-jsrt": generate_jsrt_cli,
}


def main(argv: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(__doc__)
        sys.exit(1)
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
