"""PyTorch port vs JAX package: the in-memory synthetic data source and the
data contracts (data/synthetic.py, data/config.py).

The port's generator draws from numpy exactly as the JAX one does and fills
polygons with a numpy even-odd test instead of matplotlib, and both
packages extract the landmarks from the label masks with the same numpy
operations, so images, label masks and contours are compared for equality.
"""

import numpy as np
import pytest

from contouring_uncertainty_tpu.data import config as jc
from contouring_uncertainty_tpu.data import synthetic as js
from contouring_uncertainty_tpu.data.camus import CamusContourData
from contouring_uncertainty_torch import factory
from contouring_uncertainty_torch.config import compose
from contouring_uncertainty_torch.data import config as tc
from contouring_uncertainty_torch.data import synthetic as ts


@pytest.mark.parametrize("size", [64, 256])
def test_make_arrays_equal_jax(size):
    """Draw for draw: the same contours, label masks and images (the even-odd
    fill at pixel centres marks the same pixels as matplotlib's
    contains_points on these polygons)."""
    ref = js.make_arrays(4, size=size, seed=2)
    got = ts.make_arrays(4, size=size, seed=2)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_synthetic_source_matches_camus_reader(tmp_path):
    """The port's `data=synthetic` source (factory.build_data with no file
    at data.dataset_path: CamusContourData over the films `make_camus_tree`
    draws in memory) equals the JAX package's CamusContourData over the
    HDF5 file that write_camus_hdf5 draws from the same seed: the same
    splits, view ids and order, images, label masks, landmark contours
    (extracted from the masks on both sides, exactly), metadata,
    data_params and contour_groups, with [BG, LV] and with [BG, LV, MYO]
    (K = 42 in two groups)."""
    path = js.write_camus_hdf5(tmp_path / "camus.h5", n_patients=5, size=64, seed=3)
    for labels in ("[BG, LV]", "[BG, LV, MYO]"):
        ref = CamusContourData(path, cache_dir=tmp_path,
                               labels=[jc.Label[l] for l in labels[1:-1].split(", ")])
        got = factory.build_data(compose([
            "data=synthetic", "data.image_size=64", "data.n_patients=5", "seed=3",
            f"data.labels={labels}", f"data.dataset_path={tmp_path / 'absent.h5'}"]))
        for split in ("train", "val", "test"):
            views_j = list(ref.predict_views(split))
            views_t = list(got.predict_views(split))
            assert [v["id"] for v in views_t] == [v["id"] for v in views_j]
            for vt, vj in zip(views_t, views_j):
                for key in ("img", "gt", "voxelspacing", "contour"):
                    assert vt[key].dtype == vj[key].dtype, key
                    np.testing.assert_array_equal(vt[key], vj[key])
                assert vt["instants"] == vj["instants"]
                assert vt["image_quality"] == vj["image_quality"]
        arr_j, arr_t = ref.train_arrays("train"), got.train_arrays("train")
        for key in ("img", "gt", "contour"):
            np.testing.assert_array_equal(arr_t[key], arr_j[key])
        assert list(arr_t["id"]) == list(arr_j["id"])
        assert got.data_params == tc.DataParams(**vars(ref.data_params))
        assert got.data_params.out_shape == (21 * len(ref.labels[1:]), 2)
        assert got.contour_groups == ref.contour_groups


def test_synthetic_source_ignores_the_shared_default_file(tmp_path, monkeypatch):
    """`data=synthetic`'s default dataset_path is one fixed file that other
    runs write: a file planted there with other films is neither read nor
    given a contour cache; the requested draws (size, patients, seed) are
    served. A file the caller names is read, its cache written beside it,
    as the JAX package does."""
    monkeypatch.delenv("SYNTH_DATA_PATH", raising=False)
    assert compose(["data=synthetic"])["data"]["dataset_path"] == factory.shared_synthetic_path()
    planted = js.write_camus_hdf5(tmp_path / "shared" / "synth.h5", n_patients=6, size=32,
                                  seed=9)
    monkeypatch.setattr(factory, "shared_synthetic_path", lambda: str(planted))
    request = ["data=synthetic", "data.image_size=64", "data.n_patients=5", "seed=3"]
    got = factory.build_data(compose(request + [f"data.dataset_path={planted}"]))
    want = ts.synthetic_camus_data(n_patients=5, size=64, seed=3)
    for key in ("img", "contour", "id"):
        np.testing.assert_array_equal(got.train_arrays("test")[key],
                                      want.train_arrays("test")[key])
    assert sorted(p.name for p in planted.parent.iterdir()) == ["synth.h5"]
    named = js.write_camus_hdf5(tmp_path / "named.h5", n_patients=6, size=32, seed=9)
    read = factory.build_data(compose(request + [f"data.dataset_path={named}"]))
    assert read.train_arrays("train")["img"].shape[-2:] == (32, 32)
    assert any(p.name.startswith("contours_train_") for p in tmp_path.iterdir())


def test_config_contracts_match_jax():
    """The port's own copy of data/config.py: same labels, tags, defaults and
    BatchResult fields with the same shape checks."""
    assert {m.name: int(m) for m in tc.Label} == {m.name: int(m) for m in jc.Label}
    tags = [k for k in vars(jc.Tags) if not k.startswith("_")]
    assert all(getattr(tc.Tags, k) == getattr(jc.Tags, k) for k in tags)
    assert list(tc.BatchResult.__dataclass_fields__) == list(jc.BatchResult.__dataclass_fields__)
    n, k, s = 2, 21, 8
    ok = dict(id="v", img=np.zeros((n, 1, s, s)), gt=None, pred=np.zeros((n, s, s)),
              labels=tc.DataParams((1, s, s), (k, 2)).labels,
              uncertainty_map=np.zeros((n, s, s)), mu=np.zeros((n, k, 2)),
              cov=np.zeros((n, k, 2, 2)), mode=np.zeros((n, k, 2)))
    tc.BatchResult(**ok)
    with pytest.raises(AssertionError):
        tc.BatchResult(**{**ok, "pred": np.zeros((n, s, s + 1))})
