"""PyTorch port vs JAX package: the CAMUS source (data/contour_extraction.py,
data/camus.py, data/synthetic.py `make_camus_tree` and `write_camus_hdf5`),
the `camus` and `camus-cont` configs, and runner.run on a CAMUS file.

Both sides are host numpy: files come from the JAX package's
`write_camus_hdf5` (or are written here in the reference generator's
layout), and every split, id, image, label mask, metadata field and
landmark contour is compared for equality.
"""

import shlex
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from contouring_uncertainty_tpu.config import compose as jcompose
from contouring_uncertainty_tpu.data import camus as jcamus
from contouring_uncertainty_tpu.data import contour_extraction as jce
from contouring_uncertainty_tpu.data import synthetic as js
from contouring_uncertainty_tpu.data.config import Label as JLabel
from contouring_uncertainty_tpu.data.transforms import normalize_sample as j_normalize_sample
from contouring_uncertainty_torch import runner
from contouring_uncertainty_torch.config import compose
from contouring_uncertainty_torch.data import camus as tcamus
from contouring_uncertainty_torch.data import contour_extraction as tce
from contouring_uncertainty_torch.data import synthetic as ts
from contouring_uncertainty_torch.data.config import DataParams, Label
from contouring_uncertainty_torch.data.transforms import normalize_sample

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LV, LV_MYO = (Label.BG, Label.LV), (Label.BG, Label.LV, Label.MYO)


def _jlabels(labels):
    return tuple(JLabel(int(l)) for l in labels)


@pytest.fixture(scope="module")
def camus_file(tmp_path_factory):
    """A CAMUS-layout file of 5 patients at 64^2 from the JAX package."""
    return js.write_camus_hdf5(tmp_path_factory.mktemp("camus") / "camus.h5",
                               n_patients=5, size=64, seed=4)


@pytest.mark.parametrize("size", [64, 256])
def test_contour_points_equal_jax(size):
    """get_contour_points on synthetic label masks, LV alone and LV + MYO
    (the convex hull filled by the port's own f64 crossing test instead of
    matplotlib): the same float32 landmarks, exactly."""
    rng = np.random.default_rng(size)
    for _ in range(6 if size == 64 else 2):
        _, gt, _ = js.make_sample(rng, 21, size)
        for include_myo in (False, True):
            ref = jce.get_contour_points(gt, 21, include_myo=include_myo)
            got = tce.get_contour_points(gt, 21, include_myo=include_myo)
            assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
        myo = gt == int(Label.MYO)
        np.testing.assert_array_equal(tce._convex_hull_mask(myo), jce._convex_hull_mask(myo))


def _assert_sources_equal(got, ref, splits=("train", "val", "test")):
    for split in splits:
        views_t, views_j = list(got.predict_views(split)), list(ref.predict_views(split))
        assert [v["id"] for v in views_t] == [v["id"] for v in views_j]
        for vt, vj in zip(views_t, views_j):
            for key in ("img", "gt", "contour", "voxelspacing"):
                assert vt[key].dtype == vj[key].dtype, key
                np.testing.assert_array_equal(vt[key], vj[key])
            assert vt["instants"] == vj["instants"]
            assert vt["image_quality"] == vj["image_quality"]
        arr_t, arr_j = got.train_arrays(split), ref.train_arrays(split)
        for key in ("img", "gt", "contour"):
            np.testing.assert_array_equal(arr_t[key], arr_j[key])
        assert list(arr_t["id"]) == list(arr_j["id"])
    assert got.data_params == DataParams(**vars(ref.data_params))
    assert got.contour_groups == ref.contour_groups


@pytest.mark.parametrize("labels", [LV, LV_MYO], ids=["LV", "LV+MYO"])
def test_reader_matches_jax_on_its_file(labels, camus_file, tmp_path):
    """CamusContourData on a file of the JAX package's write_camus_hdf5:
    every split, id, array and contour equal; K = 21, or 42 in two groups
    with MYO painted first and the LV last."""
    got = tcamus.CamusContourData(camus_file, labels=labels, cache_dir=tmp_path / "t")
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    ref = jcamus.CamusContourData(camus_file, labels=_jlabels(labels), cache_dir=tmp_path / "j")
    _assert_sources_equal(got, ref)
    k = 21 * (len(labels) - 1)
    assert got.data_params.out_shape == (k, 2)
    assert got.contour_groups[-1] == (0, 21, int(Label.LV))


def _write_reference_layout(path):
    """Two patients in the reference generator's layout: img_proc
    (N, H, W, 1) in 0..255, three frames with ED 0 and ES 2, ImageQuality a
    dataset inside the view group."""
    rng = np.random.default_rng(8)
    with h5py.File(path, "w") as f:
        for split, ids in (("train", ["p1"]), ("val", ["p2"]), ("test", ["p2"])):
            f.create_dataset(f"cross_validation/fold_2/{split}", data=np.array(ids, dtype="S"))
        for pid in ("p1", "p2"):
            frames = [js.make_sample(rng, 21, 64) for _ in range(3)]
            g = f.create_group(f"{pid}/4CH")
            g.create_dataset("img_proc", data=np.stack([fr[0] for fr in frames])[..., None] * 255)
            g.create_dataset("gt_proc", data=np.stack([fr[1] for fr in frames]))
            g.create_dataset("ImageQuality", data=b"Poor")
            g.attrs["instants"] = np.array(["ED", "ES"], dtype="S")
            g.attrs["ED"], g.attrs["ES"] = 0, 2
            g.attrs["voxelspacing"] = np.array([1.0, 0.3, 0.3])
    return path


@pytest.mark.parametrize("use_sequence", [False, True])
def test_reader_layout_sequence_and_transform_match_jax(use_sequence, tmp_path):
    """A file in the reference generator's layout (trailing channel axis,
    0..255 images, a third frame, ImageQuality as a dataset) read with
    fold 2, a per-frame normalization transform and `use_sequence`: the
    key instants (frames 0 and 2), or with use_sequence every frame, equal
    to the JAX reader's."""
    path = _write_reference_layout(tmp_path / "ref.h5")
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = tcamus.CamusContourData(path, fold=2, cache_dir=tmp_path / "t",
                                  use_sequence=use_sequence, transform=normalize_sample())
    ref = jcamus.CamusContourData(path, fold=2, cache_dir=tmp_path / "j",
                                  use_sequence=use_sequence, transform=j_normalize_sample())
    _assert_sources_equal(got, ref)
    ids = list(got.train_arrays("train")["id"])
    assert ids == (["p1/4CH_0", "p1/4CH_1", "p1/4CH_2"] if use_sequence
                   else ["p1/4CH_0", "p1/4CH_2"])
    view = next(got.predict_views("test"))
    assert view["image_quality"] == "Poor" and view["instants"] == {"ED": 0, "ES": 2}
    assert abs(float(view["img"][0].mean())) < 1e-4  # normalized frames


def test_contour_cache_is_shared_between_packages(camus_file, tmp_path):
    """A contour cache either package writes is read by the other: same
    file name and keys. Each reader is handed the other's cache with the
    landmarks shifted by 1000 and returns them shifted."""
    for writer, reader in ((tcamus, jcamus), (jcamus, tcamus)):
        d = tmp_path / writer.__name__.split(".")[0]
        d.mkdir()
        labels = LV if writer is tcamus else _jlabels(LV)
        first = writer.CamusContourData(camus_file, labels=labels, cache_dir=d)
        contours = first.train_arrays("train")["contour"]
        (cache,) = d.glob("contours_*.npz")
        labels = LV if reader is tcamus else _jlabels(LV)
        second = reader.CamusContourData(camus_file, labels=labels, cache_dir=d)
        assert second._cache_path("train") == cache
        np.savez_compressed(cache, **{k: v + 1000 for k, v in np.load(cache).items()})
        np.testing.assert_array_equal(second.train_arrays("train")["contour"], contours + 1000)


def test_from_arrays_and_writer_match_the_jax_file(camus_file, tmp_path):
    """`make_camus_tree` holds what the JAX package's write_camus_hdf5 writes
    for the same arguments (every dataset and attribute); the port's
    writer writes it; and `CamusContourData.from_arrays` over the tree
    reads what the reader reads from the file, with and without MYO."""
    tree = ts.make_camus_tree(n_patients=5, size=64, seed=4)
    path = ts.write_camus_hdf5(tmp_path / "port.h5", n_patients=5, size=64, seed=4)
    for written in (camus_file, path):
        with h5py.File(written, "r") as f:
            names = []
            f.visit(names.append)
            assert sorted(names) == sorted(_tree_paths(tree))
            for name in names:
                node, mine = f[name], tree[name]
                if isinstance(node, h5py.Dataset):
                    np.testing.assert_array_equal(node[()], mine)
                    assert node.dtype == mine.dtype, name
                for key, value in node.attrs.items():
                    assert key in mine.attrs, (name, key)
                    np.testing.assert_array_equal(value, mine.attrs[key])
            assert dict(f.attrs) == tree.attrs
    for labels in (LV, LV_MYO):
        (tmp_path / str(len(labels))).mkdir()
        _assert_sources_equal(
            tcamus.CamusContourData.from_arrays(tree, labels=labels),
            jcamus.CamusContourData(camus_file, labels=_jlabels(labels),
                                    cache_dir=tmp_path / str(len(labels))))


def _tree_paths(group, prefix=""):
    for name, member in group.members.items():
        yield prefix + name
        if isinstance(member, tcamus.Group):
            yield from _tree_paths(member, prefix + name + "/")


def test_iterate_batches_matches_jax(camus_file, tmp_path):
    """Epoch batches of the training arrays, shuffled and in order, full
    and with the short last batch kept."""
    arrays = tcamus.CamusContourData(camus_file, cache_dir=tmp_path).train_arrays("train")
    for shuffle, drop_last in ((True, True), (False, False)):
        got = list(tcamus.iterate_batches(arrays, 5, np.random.default_rng(1), shuffle, drop_last))
        ref = list(jcamus.iterate_batches(arrays, 5, np.random.default_rng(1), shuffle, drop_last))
        assert len(got) == len(ref) > 0
        for b_t, b_j in zip(got, ref):
            for key in b_j:
                np.testing.assert_array_equal(b_t[key], b_j[key])


def _recipes(script, dataset):
    """The runner overrides of each `python runner.py` line of a TMI script."""
    text = (REPO / "tmi_scripts" / script).read_text()
    for var, value in (("${SEED}", "1"), ("${dataset}", dataset), ("${TAG}", "TMI_FINAL_TEST")):
        text = text.replace(var, value)
    return [shlex.split(line)[2:] for line in text.splitlines()
            if line.startswith("python runner.py")]


@pytest.mark.parametrize("dataset", ["camus", "lung"])
def test_tmi_recipes_compose_as_in_jax(dataset):
    """Every recipe of tmi_scripts/train.sh and test.sh, for CAMUS and for
    JSRT, composes to the JAX package's config (24 a dataset)."""
    recipes = _recipes("train.sh", dataset) + _recipes("test.sh", dataset)
    assert len(recipes) == 24
    for overrides in recipes:
        assert compose(overrides) == jcompose(overrides), overrides


@pytest.mark.parametrize("data,task", [("camus-cont", "dsnt-al"), ("camus", "mcdropout")])
def test_runner_runs_camus_on_the_cpu(data, task, tmp_path):
    """runner.run on a file of the port's write_camus_hdf5 (LV + MYO for
    the contour task): trains one epoch, tests and predicts the test views
    and runs the config's results processors without an error."""
    path = ts.write_camus_hdf5(tmp_path / "camus.h5", n_patients=5, size=64, seed=2)
    overrides = [f"data={data}", f"task={task}", f"data.dataset_path={path}",
                 "task.model.kernels=[[3,3],[3,3],[3,3],[3,3]]",
                 "task.model.strides=[[1,1],[2,2],[2,2],[2,2]]", "task.t_a=3", "task.t_e=2",
                 "trainer.max_epochs=1", "trainer.batch_size=4", f"save_path={tmp_path}",
                 f"task.psm_path={tmp_path / 'psm.npz'}"]
    if data == "camus-cont":
        overrides.append("data.labels=[BG, LV, MYO]")
    result = runner.run(overrides, device="cpu")
    assert "processor_errors" not in result and "test_error" not in result
    views = result["predict"]
    assert len(views) == 2
    metrics = (tmp_path / "results" / "metrics.json").read_text()
    for name in compose(overrides)["data"]["results_processors"]:
        assert name in metrics or name == "point_metrics"
    if data == "camus-cont":
        for view in views:
            assert view.mu.shape == (2, 42, 2)
            assert set(np.unique(view.pred_samples)) <= {0, 1, 2}
            # The LV (1) is painted over the MYO (2): both appear.
            assert {1, 2} <= set(np.unique(view.pred_samples))
