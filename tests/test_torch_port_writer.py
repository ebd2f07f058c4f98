"""PyTorch port vs JAX package: the HDF5 prediction writer
(results/extras.py `prediction_writer`) and the figure logger
(train/logging.py `log_figure`).

- `predictions.h5` against JAX's for the same views (DSNT-AL views served
  by the port at 64^2, the same views with a skew `alpha`, and with only
  the segmentation fields): the same groups, dataset names, dtypes,
  shapes, compression and attributes, the values bitwise;
- without h5py (`sys.modules["h5py"] = None`) the writer fails into
  `processor_errors`, writes nothing, and the other processors run;
- `log_figure` writes figures/{name}_{step}.png and a TensorBoard image.
"""

import dataclasses
import sys

import matplotlib

matplotlib.use("Agg")
import h5py
import numpy as np
import pytest
import torch
from matplotlib import pyplot as plt

from contouring_uncertainty_tpu.results import run_processors as j_run
from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch.data.synthetic import synthetic_camus_data
from contouring_uncertainty_torch.results import run_processors
from contouring_uncertainty_torch.tasks import DSNTAleatoric
from contouring_uncertainty_torch.train.logging import ExperimentLogger
from test_torch_port_results import to_jax

torch.set_num_threads(1)

SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3, drop_block=True)
WRITER = {"data": {"results_processors": ["prediction_writer"]}}


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    data = synthetic_camus_data(n_patients=5, size=64, seed=2)
    task = DSNTAleatoric(data_params=data.data_params, t_e=2, t_a=2, model_kwargs=SMALL)
    model = task.build_model(device="cpu", generator=torch.Generator().manual_seed(0))
    cfg = {"seed": 3, "task": {"psm_path": str(tmp_path_factory.mktemp("prior") / "p.npz")}}
    results = tpred.run_predict(task, model, data, cfg, device="cpu")
    assert len(results) == 2
    return results


def _with_alpha(res):
    alpha = np.random.default_rng(0).normal(size=res.mu.shape).astype(np.float32)
    return dataclasses.replace(res, alpha=alpha)


def _segmentation(res):
    return dataclasses.replace(res, mu=None, mode=None, cov=None, post_mu=None, post_cov=None,
                               contour=None, entropy_map=None, contour_samples=None)


KINDS = {"contour": lambda r: r, "skew": _with_alpha, "segmentation": _segmentation}


def _h5_tree(path):
    """Every group and dataset of an HDF5 file: name -> (kind, attributes,
    and for a dataset its dtype, shape, compression, options, chunks and
    values)."""
    tree = {}

    def visit(name, obj):
        attrs = {k: (np.asarray(v).dtype.str, np.asarray(v).tolist()) for k, v in obj.attrs.items()}
        if isinstance(obj, h5py.Dataset):
            tree[name] = ("dataset", attrs, obj.dtype.str, obj.shape, obj.compression,
                          obj.compression_opts, obj.chunks, obj[()])
        else:
            tree[name] = ("group", attrs)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return tree


@pytest.mark.parametrize("kind", list(KINDS))
def test_prediction_writer_matches_jax(views, tmp_path, kind):
    """predictions.h5 of the port and of the JAX package for the same
    views: the same groups and datasets, each with JAX's dtype, shape,
    compression (gzip for the maps) and chunks, values bitwise, and the
    same attributes (instants, voxel spacing)."""
    results = [KINDS[kind](r) for r in views]
    got = run_processors(results, tmp_path / "port", WRITER, device="cpu")
    ref = j_run([to_jax(r) for r in results], tmp_path / "jax", WRITER)
    assert got == ref == {"prediction_writer/written_views": 2}
    tree, ref_tree = (_h5_tree(tmp_path / side / "predictions.h5") for side in ("port", "jax"))
    assert list(tree) == list(ref_tree)
    datasets = [name for name, entry in tree.items() if entry[0] == "dataset"]
    want = {"contour": 9, "skew": 10, "segmentation": 2}[kind]
    assert len(datasets) == want * len(results)
    assert tree[f"{results[0].id}/pred"][4] == "gzip"
    for name, entry in tree.items():
        assert entry[:-1] == ref_tree[name][:-1] if entry[0] == "dataset" \
            else entry == ref_tree[name], name
        if entry[0] == "dataset":
            np.testing.assert_array_equal(entry[-1], ref_tree[name][-1], err_msg=name)
    group = tree[results[0].id]
    assert set(group[1]) == {"ED", "ES", "voxelspacing"}


def test_prediction_writer_without_h5py_writes_nothing(views, tmp_path, monkeypatch):
    """Without h5py the writer fails into processor_errors (h5py named),
    writes no predictions.h5, and the other processors still run."""
    for name in [m for m in sys.modules if m == "h5py" or m.startswith("h5py.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "h5py", None)
    got = run_processors(views, tmp_path, {"data": {"results_processors": [
        "prediction_writer", "sigma_stats"]}}, device="cpu")
    (error,) = got["processor_errors"].values()
    assert list(got["processor_errors"]) == ["prediction_writer"]
    assert error.startswith("ModuleNotFoundError: ") and "h5py" in error
    assert not (tmp_path / "predictions.h5").exists()
    assert "figure_errors" not in got and "sigma_stats/avg_distance" in got


def test_log_figure_writes_png_and_tensorboard_image(tmp_path):
    """log_figure with the real TensorBoard writer: figures/{name}_{step}.png
    at dpi 80, and an image under the name in the event file."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    logger = ExperimentLogger(tmp_path, "run", use_tensorboard=True)
    fig = plt.figure(figsize=(2, 2))
    fig.gca().plot([0, 1], [1, 0])
    logger.log_figure("val_contours", fig, step=5)
    plt.close(fig)
    logger.close()
    png = plt.imread(tmp_path / "figures" / "val_contours_5.png")
    assert png.shape[:2] == (160, 160)
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert acc.Tags()["images"] == ["val_contours"]
    assert [e.step for e in acc.Images("val_contours")] == [5]
