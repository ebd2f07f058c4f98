"""PyTorch port vs JAX package: the in-memory synthetic data source and the
data contracts (data/synthetic.py, data/config.py).

The port's generator draws from numpy exactly as the JAX one does and fills
polygons with a numpy even-odd test instead of matplotlib, so images, label
masks and contours are compared for equality.
"""

import numpy as np
import pytest

from contouring_uncertainty_tpu.data import config as jc
from contouring_uncertainty_tpu.data import synthetic as js
from contouring_uncertainty_tpu.data.camus import CamusContourData
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
    """SyntheticContourData exposes what run_predict reads of the JAX
    package's CamusContourData over the HDF5 file that write_camus_hdf5
    draws from the same seed: the same splits, view ids and order, images,
    label masks, metadata, data_params and contour_groups. (Landmarks are
    the generating contours here; the HDF5 reader re-extracts them from the
    masks, so those are compared by shape only.)"""
    path = js.write_camus_hdf5(tmp_path / "camus.h5", n_patients=5, size=64, seed=3)
    ref = CamusContourData(path, cache_dir=tmp_path)
    got = ts.SyntheticContourData(n_patients=5, size=64, seed=3)
    for split in ("train", "val", "test"):
        views_j = list(ref.predict_views(split))
        views_t = list(got.predict_views(split))
        assert [v["id"] for v in views_t] == [v["id"] for v in views_j]
        for vt, vj in zip(views_t, views_j):
            for key in ("img", "gt", "voxelspacing"):
                np.testing.assert_array_equal(vt[key], vj[key])
            assert vt["contour"].shape == vj["contour"].shape
            assert vt["instants"] == vj["instants"]
            assert vt["image_quality"] == vj["image_quality"]
    arr_j, arr_t = ref.train_arrays("train"), got.train_arrays("train")
    np.testing.assert_array_equal(arr_t["img"], arr_j["img"])
    assert list(arr_t["id"]) == list(arr_j["id"])
    assert got.data_params == tc.DataParams(**vars(ref.data_params))
    assert got.contour_groups == ref.contour_groups


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
