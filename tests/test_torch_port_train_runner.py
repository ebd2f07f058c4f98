"""PyTorch port vs JAX package: config composition, the factory and the
runner (config/compose.py, factory.py, runner.py), and the whole training
slice on the CPU: runner.run trains, tests and predicts.
"""

import dataclasses
from pathlib import Path

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


@pytest.mark.parametrize("override,ranks", [("predict_sample_parallel=3", 2)])
def test_sample_parallel_that_does_not_divide_the_ranks_raises(override, ranks, tmp_path,
                                                               monkeypatch):
    """`predict_sample_parallel` that does not divide the process group's
    ranks (here the count the runner reads, set to 2) raises the JAX
    runner's ValueError from runner.run before any training, where the JAX
    runner raises it after (it checks when it builds its serving mesh);
    unknown config options raise. The same on two real ranks:
    tests/test_torch_port_parallel.py."""
    from contouring_uncertainty_torch import predict as tpred

    monkeypatch.setattr(tpred, "world_size", lambda: ranks)
    overrides = ["data=synthetic", "data.image_size=32", "data.n_patients=5",
                 "task.model.kernels=[[3,3],[3,3],[3,3]]",
                 "task.model.strides=[[1,1],[2,2],[2,2]]", f"save_path={tmp_path}", override]
    with pytest.raises(ValueError, match=r"predict_sample_parallel=3 must divide the device "
                                         r"count \(2\)"):
        runner.run(overrides, device="cpu")
    assert not any(tmp_path.iterdir())  # nothing trained
    assert compose(["data=lung"])["data"]["labels"] == ["BG", "LUNG", "HEART"]
    with pytest.raises(ValueError, match="Unknown option 'echonet' for config group 'data'"):
        compose(["data=echonet"])


# These two cases raised while the loggers' back ends and deep ensembles
# (ROADMAP.md item 5) were not ported; each now reaches the trainer or the
# runner as in the JAX package.
FORMERLY_UNPORTED_RUN_OPTIONS = ["comet=true", "task.train_ensemble=3"]


@pytest.mark.parametrize("override", FORMERLY_UNPORTED_RUN_OPTIONS)
def test_formerly_unported_run_options_are_taken(override, capsys):
    """`comet=true` composes as in the JAX package and sets the trainer's
    `use_comet` as the JAX factory sets it; without comet_ml the logger
    says so and keeps its JSONL file. `task.train_ensemble=3` composes as
    in the JAX package and passes the runner's checks."""
    overrides = ["data=synthetic", "data.image_size=32", "data.n_patients=5", override]
    cfg = compose(overrides)
    assert cfg == jcompose(overrides)
    runner.check_predict_options(cfg)
    if override.startswith("comet"):
        config = factory.build_trainer(cfg, None, device="cpu").config
        assert config.use_comet is _jax_trainer_config(cfg).use_comet is True
        import tempfile

        from contouring_uncertainty_torch.train.logging import ExperimentLogger

        with tempfile.TemporaryDirectory() as d:
            logger = ExperimentLogger(d, "x", use_comet=True)
            logger.log_metrics({"loss": 1.0}, step=0)
            logger.close()
            assert '"loss": 1.0' in (Path(d) / "x_metrics.jsonl").read_text()
        assert "comet unavailable" in capsys.readouterr().out
    else:
        assert cfg["task"]["train_ensemble"] == 3


# These five cases raised while the CAMUS source (ROADMAP.md item 2) and the
# other backbones and UNet flags (item 9) were not ported; each now checks
# that the option builds.
PORTED_OPTIONS = {
    "data.name=camus-cont reads a CAMUS file": ["data=camus-cont"],
    "task.model.name=deeplabv3 builds": ["task/model=deeplabv3"],
    "task.model.name=enet builds": ["task/model=enet"],
    "task.model.residual=true builds": ["task.model.residual=true"],
    "task.model.attention=true builds": ["task.model.attention=true"],
}


@pytest.mark.parametrize("name", list(PORTED_OPTIONS))
def test_formerly_unported_configurations_build(name, tmp_path):
    """Each option composes as in the JAX package; the port's factory builds
    its data source (the CAMUS reader on a file of the port's
    write_camus_hdf5: JAX's data_params and landmarks) or its backbone,
    whose forward gives (N, 21, H, W) heatmaps."""
    from contouring_uncertainty_tpu.data.camus import CamusContourData as JCamus
    from contouring_uncertainty_torch.data.synthetic import write_camus_hdf5

    path = write_camus_hdf5(tmp_path / "camus.h5", n_patients=5, size=64, seed=1)
    overrides = [*PORTED_OPTIONS[name], f"data.dataset_path={path}"]
    cfg = compose(overrides)
    assert cfg == jcompose(overrides)
    data = factory.build_data(cfg)
    (tmp_path / "jax").mkdir()
    ref = JCamus(path, cache_dir=tmp_path / "jax")
    assert data.data_params == DataParams(**vars(ref.data_params))
    np.testing.assert_array_equal(data.train_arrays("train")["contour"],
                                  ref.train_arrays("train")["contour"])
    if name.startswith("data"):
        return
    for key in ("kernels", "strides"):  # a 4-stage UNet at 64^2
        if key in cfg["task"]["model"]:
            cfg["task"]["model"][key] = cfg["task"]["model"][key][:4]
    task = factory.build_task(cfg, data.data_params)
    model = task.build_model(device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(torch.as_tensor(data.train_arrays("train")["img"][:2]))["out"]
    assert out.shape == (2, 21, 64, 64) and torch.isfinite(out).all()


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
