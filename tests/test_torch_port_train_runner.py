"""PyTorch port vs JAX package: config composition, the factory and the
runner (config/compose.py, factory.py, runner.py), and the whole training
slice on the CPU: runner.run trains, tests and predicts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from contouring_uncertainty_tpu import factory as jfactory
from contouring_uncertainty_tpu.config import compose as jcompose
from contouring_uncertainty_torch import factory, runner
from contouring_uncertainty_torch.config import compose
from contouring_uncertainty_torch.data.config import DataParams
from contouring_uncertainty_torch.train.checkpoint import load_meta, resolve_checkpoint

torch.set_num_threads(1)

OVERRIDE_SETS = {
    "defaults": [],
    "synthetic": ["data=synthetic"],
    "flagship_training": ["data=synthetic", "task=dsnt-al", "task.model.drop_block=True",
                          "task.optim.name=adamw", "trainer.batch_size=32",
                          "trainer.max_epochs=3", "seed=0", "save_path=${env:HOME}/runs"],
    "rmsprop_schedule": ["data=synthetic", "task/optim=rmsprop", "task.optim.lr=3e-4",
                         "task.optim.schedule=cosine", "task.optim.warmup_steps=10",
                         "++comet_tags=[a, b]", "trainer.augment=off", "trainer.patience=~"],
    "sgd_small_model": ["data=synthetic", "task/optim=sgd", "task.optim.momentum=0.9",
                        "task.model.kernels=[[3,3],[3,3],[3,3],[3,3]]",
                        "task.model.strides=[[1, 1], [2, 2], [2, 2], [2, 2]]",
                        "data.image_size=64", "data.n_patients=5", "task.t_e=10",
                        "train=false", "weights='some/dir'"],
}


@pytest.mark.parametrize("name", list(OVERRIDE_SETS))
def test_compose_matches_jax(name, monkeypatch):
    """The JSON-composed config equals the JAX package's YAML-composed one:
    group selections, defaults, dotted overrides parsed as YAML scalars and
    lists, env resolution. The factory reads it the same way: experiment
    name, model arguments, and every TrainerConfig field the port has."""
    monkeypatch.setenv("SAVE_PATH", "/runs/here")
    overrides = OVERRIDE_SETS[name]
    cfg, jcfg = compose(overrides), jcompose(overrides)
    assert cfg == jcfg
    assert factory.experiment_name(cfg) == jfactory.experiment_name(jcfg)
    kwargs = factory.model_kwargs_from_cfg(cfg["task"]["model"])
    jkwargs = jfactory.model_kwargs_from_cfg(jcfg["task"]["model"])
    assert {k: str(v).split(".")[-1] if k == "dtype" else v for k, v in kwargs.items()} == \
        {k: np.dtype(v).name if k == "dtype" else v for k, v in jkwargs.items()}
    if name == "defaults":
        return
    size = cfg["data"]["image_size"]
    task = factory.build_task(cfg, DataParams(in_shape=(1, size, size), out_shape=(21, 2)))
    trainer = factory.build_trainer(cfg, task, device="cpu")
    jconfig = dataclasses.asdict(_jax_trainer_config(jcfg))
    for key, value in dataclasses.asdict(trainer.config).items():
        assert value == jconfig[key], key


def _jax_trainer_config(cfg):
    """The TrainerConfig the JAX factory builds, without building its model."""
    captured = {}

    class Capture:
        def __init__(self, task, config):
            captured["config"] = config

    original = jfactory.Trainer
    jfactory.Trainer = Capture
    try:
        jfactory.build_trainer(cfg, None)
    finally:
        jfactory.Trainer = original
    return captured["config"]


@pytest.mark.parametrize("override,item", [
    ("data.name=camus-cont", "item 2"), ("data.name=lung", "item 10"),
    ("task.name=dsnt-skew", "item 6"), ("task.name=epistemic", "item 7"),
    ("task.name=tta", "item 8"), ("comet=true", "Queue 1"),
    ("predict_batch_views=4", "item 3"), ("task.train_ensemble=3", "item 5"),
])
def test_unported_configurations_raise_naming_the_roadmap(override, item, tmp_path):
    """Data sources, tasks, loggers and run modes the port does not have yet
    raise NotImplementedError naming their ROADMAP.md item, before any
    training."""
    overrides = ["data=synthetic", "data.image_size=32", "data.n_patients=5",
                 "task.model.kernels=[[3,3],[3,3],[3,3]]",
                 "task.model.strides=[[1,1],[2,2],[2,2]]", f"save_path={tmp_path}", override]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1.*{item}|{item}"):
        runner.run(overrides, device="cpu")
    with pytest.raises(ValueError, match="Unknown option 'lung' for config group 'data'"):
        compose(["data=lung"])


def test_runner_trains_tests_and_predicts_on_the_cpu(tmp_path, capsys):
    """The whole slice: runner.run(device="cpu") on a small synthetic
    configuration trains (augmentation and MC dropout on), writes the best
    checkpoint, computes the test metrics through val_metrics and predicts
    every test view with the trained weights. The eval-only branch
    (train=false) loads that checkpoint and gives the same test metrics,
    and the command line entry point runs it too."""
    overrides = ["data=synthetic", "data.image_size=64", "data.n_patients=5",
                 "task.model.kernels=[[3,3],[3,3],[3,3],[3,3]]",
                 "task.model.strides=[[1,1],[2,2],[2,2],[2,2]]",
                 "task.model.drop_block=true", "task.optim.name=adamw", "task.t_a=4",
                 "trainer.batch_size=4", "trainer.max_epochs=2", f"save_path={tmp_path}",
                 f"task.psm_path={tmp_path / 'psm.npz'}", "seed=4"]
    result = runner.run(overrides, device="cpu")
    assert [row["epoch"] for row in result["history"]] == [0, 1]
    ckpt = resolve_checkpoint(result["ckpt_path"])
    assert load_meta(ckpt)["task_name"] == "dsnt-al"
    test = result["test_metrics"]
    assert set(test) == {"test/loss", "test/distance_loss", "test/loss_term1",
                         "test/loss_term2", "test/dice"}
    assert all(np.isfinite(v) for v in test.values())
    views = result["predict"]
    assert len(views) == 2
    for view in views:
        assert view.mu.shape == (2, 21, 2) and view.contour_samples.shape == (2, 1, 4, 21, 2)
        assert np.isfinite(view.uncertainty_map).all() and view.pred.shape == (2, 64, 64)

    evaluated = runner.run(overrides + ["train=false", "predict=false"], device="cpu")
    assert evaluated["ckpt_path"] == str(ckpt)
    for key, value in test.items():
        np.testing.assert_allclose(evaluated["test_metrics"][key], value, rtol=1e-6)
    runner.main(overrides + ["train=false", "predict=false", "--device=cpu"])
    assert f"checkpoint: {ckpt}" in capsys.readouterr().out
