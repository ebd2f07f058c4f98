"""Faults of the PyTorch port against the JAX package, each gated here:

- the `data/transform` config group is composed and applied as the JAX
  package applies it (data/transforms.py, factory.build_data);
- `task.sequence_sampler` and `task.soft_mask`, not ported yet, raise
  instead of being ignored, from the runner and from run_predict;
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
from contouring_uncertainty_torch.results import NOT_PORTED

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


@pytest.mark.parametrize("key", ["sequence_sampler", "soft_mask"])
@pytest.mark.parametrize("entry", ["runner", "run_predict"])
def test_unported_predict_options_raise(key, entry, tmp_path):
    """task.sequence_sampler / task.soft_mask = true raise NotImplementedError
    naming ROADMAP.md Queue 1 item 4, from runner.run (before training) and
    from run_predict called directly; false, the default, runs."""
    overrides = SMALL_RUN + [f"save_path={tmp_path}", f"task.{key}=true"]
    match = r"ROADMAP.md Queue 1, item 4"
    if entry == "runner":
        with pytest.raises(NotImplementedError, match=match):
            runner.run(overrides, device="cpu")
        assert not any(tmp_path.iterdir())  # nothing trained
        return
    cfg = compose(overrides)
    data = factory.build_data(cfg)
    task = factory.build_task(cfg, data.data_params)
    model = task.build_model(device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        tpred.run_predict(task, model, data, cfg, device="cpu")
    cfg["task"][key] = False
    cfg["task"]["psm_path"] = str(tmp_path / "psm.npz")
    cfg.pop("save_path")
    assert len(tpred.run_predict(task, model, data, cfg, device="cpu")) == 2


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
    "data camus-cont": ("CAMUS", lambda: factory.build_data(
        compose(["data=camus-cont"]))),
    "data lung": ("JSRT", lambda: factory.build_data({"data": {"name": "lung"}})),
    "task dsnt-skew": ("Skew", lambda: factory.build_task(
        compose(["task.name=dsnt-skew"]), None)),
    "task epistemic": ("Epistemic", lambda: factory.build_task(
        compose(["task.name=epistemic"]), None)),
    "task tta": ("Segmentation baselines", lambda: factory.build_task(
        compose(["task.name=tta"]), None)),
    "predict_batch_views": ("predict_batch_views", lambda: runner._check_ported(
        compose(["predict_batch_views=4"]))),
    "train_ensemble": ("Training", lambda: runner._check_ported(
        compose(["task.train_ensemble=3"]))),
    "predict_sample_parallel": ("Multi-GPU", lambda: runner._check_ported(
        compose(["predict_sample_parallel=2"]))),
    "sequence_sampler": ("Sequence sampler", lambda: runner._check_ported(
        compose(["task.sequence_sampler=true"]))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_not_ported_messages_name_their_roadmap_item(case):
    """Each "not ported yet" error names the ROADMAP.md Queue 1 item whose
    heading holds that feature."""
    keyword, fn = CASES[case]
    item = int(re.search(r"ROADMAP\.md Queue 1, item (\d+)", _message(fn)).group(1))
    assert keyword.lower() in _roadmap_items()[item].lower(), (case, item)


@pytest.mark.parametrize("name", list(NOT_PORTED))
def test_unported_processors_name_their_roadmap_item(name):
    keyword = {"skewness": "Skew", "lung_clinical": "JSRT", "plotting": "Figures",
               "prediction_writer": "prediction writer"}[name]
    assert keyword.lower() in _roadmap_items()[NOT_PORTED[name]].lower()
