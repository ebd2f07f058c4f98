"""Faults of the PyTorch port against the JAX package, each gated here:

- the `data/transform` config group is composed and applied as the JAX
  package applies it (data/transforms.py, factory.build_data);
- options of the predict path that are not ported yet (several devices)
  raise instead of being ignored, from the runner and from run_predict,
  and `predict_mesh` is read as the JAX runner reads it (fault F6),
  and a multi-structure data source, which raised before JSRT was ported,
  now serves through both, the lowest label winning overlaps;
- every "not ported yet" message names the ROADMAP.md item that holds it.

(The NaN rule of the crossing selection is gated in
tests/test_torch_port_raster.py.)
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from contouring_uncertainty_tpu import factory as jfactory
from contouring_uncertainty_tpu.config import compose as jcompose
from contouring_uncertainty_torch import factory, runner
from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch.config import compose
from contouring_uncertainty_torch.results import FIGURES_NOT_PORTED, NOT_PORTED
from contouring_uncertainty_torch.train.logging import ExperimentLogger

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
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
# item 10 landed.
UNPORTED_PREDICT = {"predict_sample_parallel": ("predict_sample_parallel=2", 11),
                    "contour_groups": (None, 10)}


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
    """Predict options the port does not have yet (several devices) raise
    NotImplementedError naming their ROADMAP.md Queue 1 item, from
    runner.run (before training) and from run_predict called directly;
    without them, run_predict runs. A data source with two contour
    structures serves through both entry points."""
    override, item = UNPORTED_PREDICT[key]
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
        return
    overrides = SMALL_RUN + [f"save_path={tmp_path}", override]
    match = rf"ROADMAP.md Queue 1, item {item}\)"
    if entry == "runner":
        with pytest.raises(NotImplementedError, match=match):
            runner.run(overrides, device="cpu")
        assert not any(tmp_path.iterdir())  # nothing trained
        return
    cfg = compose(SMALL_RUN + [f"save_path={tmp_path}"])
    data = factory.build_data(cfg)
    task = factory.build_task(cfg, data.data_params)
    model = task.build_model(device="cpu")
    cfg["task"]["psm_path"] = str(tmp_path / "psm.npz")
    cfg.pop("save_path")
    with pytest.raises(NotImplementedError, match=match):
        tpred.run_predict(task, model, data, {**cfg, "predict_sample_parallel": 2}, device="cpu")
    assert len(tpred.run_predict(task, model, data, cfg, device="cpu")) == 2


@pytest.mark.parametrize("entry", ["runner", "run_predict"])
def test_predict_mesh_is_read_as_the_jax_runner_reads_it(entry, tmp_path, monkeypatch, capsys):
    """`predict_mesh` (fault F6, read by nothing before): a value the JAX
    runner refuses raises its ValueError, from runner.run before anything is
    trained and from run_predict; the true/false spellings are read as
    "auto" and "false"; with "auto" and several visible GPUs the port
    serves on one device and says so."""
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
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    tpred._note_single_device({"predict_mesh": True}, torch.device("cuda"))
    assert "serving on one device" in capsys.readouterr().out
    tpred._note_single_device({"predict_mesh": "off"}, torch.device("cuda"))
    tpred._note_single_device({}, torch.device("cpu"))
    assert capsys.readouterr().out == ""


def _roadmap_items():
    """ROADMAP.md Queue 1: item number -> heading."""
    text = (REPO / "ROADMAP.md").read_text()
    queue = text.split("### Queue 1", 1)[1].split("\n### ", 1)[0]
    return {int(n): title for n, title in re.findall(r"^(\d+)\. \*\*(.+?)\*\*", queue, re.M)}


def _message(fn):
    with pytest.raises(NotImplementedError) as info:
        fn()
    return str(info.value)


CASES = {
    # The first six cases held the CAMUS source (item 2) and the other
    # backbones and UNet flags (item 9) before they were ported; they hold
    # options that stay unported.
    "tensorboard, logger": ("Training", lambda: ExperimentLogger(
        "unused", "x", use_tensorboard=True)),
    "comet, logger": ("Training", lambda: ExperimentLogger("unused", "x", use_comet=True)),
    "tensorboard, runner.run": ("Training", lambda: runner.run(
        SMALL_RUN + ["tensorboard=true"], device="cpu")),
    "comet, runner.run": ("Training", lambda: runner.run(SMALL_RUN + ["comet=true"],
                                                         device="cpu")),
    "train_ensemble, runner.run": ("Training", lambda: runner.run(
        SMALL_RUN + ["task.train_ensemble=2"], device="cpu")),
    "predict_sample_parallel, run_predict entry": ("Multi-GPU", lambda: tpred.run_predict(
        None, None, None, {"predict_sample_parallel": 2}, device="cpu")),
    "train_ensemble": ("Training", lambda: runner._check_ported(
        compose(["task.train_ensemble=3"]))),
    "predict_sample_parallel": ("Multi-GPU", lambda: runner._check_ported(
        compose(["predict_sample_parallel=2"]))),
    "predict_sample_parallel, run_predict": ("Multi-GPU", lambda: tpred.check_predict_options(
        {"predict_sample_parallel": 4})),
}


@pytest.mark.parametrize("case", list(CASES))
def test_not_ported_messages_name_their_roadmap_item(case, tmp_path, monkeypatch):
    """Each "not ported yet" error names the ROADMAP.md Queue 1 item whose
    heading holds that feature; a run refused writes nothing."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SAVE_PATH", raising=False)
    keyword, fn = CASES[case]
    item = int(re.search(r"ROADMAP\.md Queue 1, item (\d+)", _message(fn)).group(1))
    assert keyword.lower() in _roadmap_items()[item].lower(), (case, item)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("name", [*NOT_PORTED, *FIGURES_NOT_PORTED])
def test_unported_processors_name_their_roadmap_item(name):
    """An unported processor, or the figure of a ported one (skewness),
    names the ROADMAP.md Queue 1 item whose heading holds it."""
    keyword = {"skewness": "Figures", "plotting": "Figures",
               "prediction_writer": "prediction writer"}[name]
    item = NOT_PORTED.get(name, FIGURES_NOT_PORTED.get(name))
    assert keyword.lower() in _roadmap_items()[item].lower()
