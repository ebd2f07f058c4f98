"""Faults of the PyTorch port against the JAX package, each gated here:

- the `data/transform` config group is composed and applied as the JAX
  package applies it (data/transforms.py, factory.build_data);
- `predict_mesh` is read as the JAX runner reads it (fault F6), and
  `predict_sample_parallel` on one rank is ignored, as the JAX runner
  ignores it on one device, from the runner and from run_predict (on
  several ranks: tests/test_torch_port_parallel.py); a multi-structure
  data source, which raised before JSRT was ported, now serves through
  both, the lowest label winning overlaps.

(The NaN rule of the crossing selection is gated in
tests/test_torch_port_raster.py.)
"""

import numpy as np
import pytest
import torch

from contouring_uncertainty_tpu import factory as jfactory
from contouring_uncertainty_tpu.config import compose as jcompose
from contouring_uncertainty_torch import factory, runner
from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch.config import compose

torch.set_num_threads(1)

SMALL_RUN = ["data=synthetic", "data.image_size=32", "data.n_patients=5",
             "task.model.kernels=[[3,3],[3,3],[3,3]]", "task.model.strides=[[1,1],[2,2],[2,2]]"]

TRANSFORMS = {
    "normalizesample": ["data/transform=normalizesample"],
    "normalize": ["data/transform=normalize", "data.transform.mean=0.2", "data.transform.std=0.5"],
    "compose": ["data/transform=compose",
                "data.transform.transforms=[{name: normalizesample}, "
                "{name: normalize, mean: 0.1, std: 2}]"],
}


@pytest.mark.parametrize("option", list(TRANSFORMS))
def test_data_transform_matches_jax(option, tmp_path):
    """Each option of the data/transform group composes to the same
    `data.transform` node in both packages, and the port's build_data
    gives the images the JAX package's build_data gives through its HDF5
    file and CAMUS reader, transformed, in train_arrays and predict_views
    (1e-6 absolute on the f32 images)."""
    overrides = ["data=synthetic", "data.image_size=64", "data.n_patients=5",
                 f"data.dataset_path={tmp_path / 'synth.h5'}", *TRANSFORMS[option]]
    cfg, jcfg = compose(overrides), jcompose(overrides)
    assert cfg["data"]["transform"] == jcfg["data"]["transform"]
    assert cfg["data"]["transform"]["name"] == option
    data, jdata = factory.build_data(cfg), jfactory.build_data(jcfg)
    got, ref = data.train_arrays("train")["img"], jdata.train_arrays("train")["img"]
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # z-scored frames, then (compose) shifted by -0.1 and halved
    expected_mean = {"normalizesample": 0.0, "compose": -0.05}.get(option)
    if expected_mean is not None:
        assert np.abs(got.mean(axis=(1, 2, 3)) - expected_mean).max() < 1e-4
    views, jviews = list(data.predict_views("test")), list(jdata.predict_views("test"))
    assert [v["id"] for v in views] == [v["id"] for v in jviews]
    for view, jview in zip(views, jviews):
        np.testing.assert_allclose(view["img"], jview["img"], rtol=0, atol=1e-6)


def test_data_transform_errors_match_jax(tmp_path):
    """`normalize` without its statistics and `compose` without transforms
    raise the JAX package's errors; no transform leaves the images as
    drawn."""
    for option, match in (("normalize", "requires data.transform.mean"),
                          ("compose", "requires data.transform.transforms")):
        overrides = ["data=synthetic", "data.image_size=32", "data.n_patients=5",
                     f"data.dataset_path={tmp_path / 'x.h5'}", f"data/transform={option}"]
        with pytest.raises(ValueError, match=match):
            factory.build_data(compose(overrides))
        with pytest.raises(ValueError, match=match):
            jfactory.build_data(jcompose(overrides))
    plain = factory.build_data(compose(["data=synthetic", "data.image_size=32",
                                        "data.n_patients=5"]))
    assert plain.train_arrays("train")["img"].min() >= 0.0


class _MultiStructure:
    """A data source whose landmark vector holds two structures."""

    def __init__(self, data):
        self.data = data
        self.data_params = data.data_params
        self.contour_groups = ((0, 10, 1), (10, 21, 2))

    def train_arrays(self, split="train"):
        return self.data.train_arrays(split)

    def predict_views(self, split="test"):
        return self.data.predict_views(split)


# Option -> (its override for the runner, its ROADMAP.md Queue 1 item);
# `contour_groups` (a data source with two structures) is served since
# item 10 landed, `predict_sample_parallel` since item 11
# (test_predict_sample_parallel_is_ignored_on_one_rank).
UNPORTED_PREDICT = {"contour_groups": (None, 10)}


def _check_two_structures(results):
    """Every sample label map of a `_MultiStructure` view is the fill of
    landmarks 0-9 painted 1 over the fill of landmarks 10-20 painted 2,
    exactly, and the two overlap somewhere."""
    from contouring_uncertainty_torch.ops.rasterize import rasterize_batch

    overlap = 0
    for res in results:
        samples = torch.as_tensor(res.contour_samples)
        h, w = res.pred.shape[-2:]
        first, second = (rasterize_batch(samples[..., a:b, :], h, w) > 0 for a, b in
                         ((0, 10), (10, 21)))
        want = torch.where(first, 1, torch.where(second, 2, 0)).to(torch.uint8)
        np.testing.assert_array_equal(res.pred_samples, want.numpy())
        assert res.pred_samples.dtype == np.uint8 and set(np.unique(res.pred)) <= {0, 1, 2}
        overlap += int((first & second).sum())
    assert overlap > 0


@pytest.mark.parametrize("key", list(UNPORTED_PREDICT))
@pytest.mark.parametrize("entry", ["runner", "run_predict"])
def test_unported_predict_options_raise(key, entry, tmp_path, monkeypatch):
    """A data source with two contour structures, which raised before item
    10 was ported, serves through runner.run and through run_predict."""
    if key == "contour_groups":
        if entry == "runner":
            monkeypatch.setattr(runner, "build_data",
                                lambda cfg: _MultiStructure(factory.build_data(cfg)))
            result = runner.run(SMALL_RUN + [f"save_path={tmp_path}", "trainer.max_epochs=1",
                                             "trainer.batch_size=4", "task.t_a=3",
                                             f"task.psm_path={tmp_path / 'psm.npz'}",
                                             "data.results_processors=[instant_metrics]"],
                                device="cpu")
            assert "processor_errors" not in result
            results = result["predict"]
        else:
            cfg = compose(SMALL_RUN + ["task.t_a=3"])
            data = factory.build_data(cfg)
            task = factory.build_task(cfg, data.data_params)
            cfg["task"]["psm_path"] = str(tmp_path / "psm.npz")
            results = tpred.run_predict(task, task.build_model(device="cpu"),
                                        _MultiStructure(data), cfg, device="cpu")
        assert len(results) == 2
        _check_two_structures(results)


@pytest.mark.parametrize("entry", ["runner", "run_predict"])
def test_predict_sample_parallel_is_ignored_on_one_rank(entry, tmp_path):
    """`predict_sample_parallel=2` in one process (one device): ignored, as
    the JAX runner ignores it with one device (it builds no mesh), through
    runner.run and through run_predict: the predictions equal those
    without it, output by output."""
    def _equal(a, b):
        assert [r.id for r in a] == [r.id for r in b] and len(a) == 2
        for x, y in zip(a, b):
            for key in ("mu", "cov", "contour_samples", "pred_samples", "pred", "entropy_map"):
                np.testing.assert_array_equal(getattr(x, key), getattr(y, key), err_msg=key)

    if entry == "runner":
        run = lambda *extra, where: runner.run(
            SMALL_RUN + [f"save_path={tmp_path / where}", "trainer.max_epochs=1",
                         "trainer.batch_size=4", "task.t_a=3", "task.t_e=2",
                         "task.model.drop_block=true",
                         f"task.psm_path={tmp_path / 'psm.npz'}",
                         "data.results_processors=[instant_metrics]", *extra],
            device="cpu")["predict"]
        _equal(run("predict_sample_parallel=2", where="s2"), run(where="plain"))
        return
    cfg = compose(SMALL_RUN + ["task.t_a=3", "task.t_e=2", "task.model.drop_block=true"])
    data = factory.build_data(cfg)
    task = factory.build_task(cfg, data.data_params)
    model = task.build_model(device="cpu")
    cfg["task"]["psm_path"] = str(tmp_path / "psm.npz")
    assert tpred.predict_mesh({**cfg, "predict_sample_parallel": 2}) is None
    _equal(tpred.run_predict(task, model, data, {**cfg, "predict_sample_parallel": 2},
                             device="cpu"),
           tpred.run_predict(task, model, data, cfg, device="cpu"))


@pytest.mark.parametrize("entry", ["runner", "run_predict"])
def test_predict_mesh_is_read_as_the_jax_runner_reads_it(entry, tmp_path):
    """`predict_mesh` (fault F6, read by nothing before): a value the JAX
    runner refuses raises its ValueError, from runner.run before anything is
    trained and from run_predict; the true/false spellings are read as
    "auto" and "false"; one process builds no serving mesh either way (with
    several ranks auto serves on all of them and false on rank 0 alone:
    tests/test_torch_port_parallel.py)."""
    match = "predict_mesh='bogus' not understood"
    if entry == "runner":
        with pytest.raises(ValueError, match=match):
            runner.run(SMALL_RUN + [f"save_path={tmp_path}", "predict_mesh=bogus"], device="cpu")
        assert not any(tmp_path.iterdir())  # nothing trained
    else:
        with pytest.raises(ValueError, match=match):
            tpred.run_predict(None, None, None, {"predict_mesh": "bogus"}, device="cpu")
    spellings = {"auto": "auto", "True": "auto", "1": "auto", "yes": "auto", "on": "auto",
                 "false": "false", "0": "false", "No": "false", "off": "false"}
    for raw, want in spellings.items():
        assert tpred.predict_mesh_mode({"predict_mesh": raw}) == want
    assert tpred.predict_mesh_mode({}) == "auto"
    for raw in ("auto", True, "off"):
        assert tpred.predict_mesh({"predict_mesh": raw}) is None
