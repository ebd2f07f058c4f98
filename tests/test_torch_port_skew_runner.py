"""The skew slice through the port's entry points on the CPU: runner.run
with task=dsnt-skew trains a SkewUNet (the skew NLL's five log keys in the
history, the metrics CSV and the JSONL log), writes its checkpoint, tests
and predicts with the skew PSM sampler, and runs the `skewness` processor;
an eval-only run loads the checkpoint back. The configs dsnt-skew5 and
dsnt-skew9 build their tasks.
"""

import json

import numpy as np
import torch

from contouring_uncertainty_tpu import factory as jfactory
from contouring_uncertainty_tpu.config import compose as jcompose
from contouring_uncertainty_torch import factory, runner
from contouring_uncertainty_torch.config import compose
from contouring_uncertainty_torch.data.config import DataParams
from contouring_uncertainty_torch.tasks import DSNTSkew
from contouring_uncertainty_torch.train.checkpoint import load_meta, resolve_checkpoint

torch.set_num_threads(1)

SKEW_LOGS = {"loss", "distance_loss", "loss_term1", "loss_term2", "loss_term3", "alpha_norm"}


def test_skew_configs_build_their_tasks_as_jax():
    """task=dsnt-skew, dsnt-skew5 and dsnt-skew9 compose to the JAX
    package's trees (skew_indices, freeze_seg, grid_window, skew_method
    included), and the factory builds a DSNTSkew with the JAX factory's
    fields (task.name=dsnt-skew on the dsnt-al group too)."""
    dp = DataParams(in_shape=(1, 64, 64), out_shape=(21, 2))
    for overrides in (["task=dsnt-skew"], ["task=dsnt-skew5", "task.freeze_seg=true"],
                      ["task=dsnt-skew9", "task.skew_method=grid"], ["task.name=dsnt-skew"]):
        cfg, jcfg = compose(overrides), jcompose(overrides)
        assert cfg == jcfg, overrides
        task, jtask = factory.build_task(cfg, dp), jfactory.build_task(jcfg, dp)
        assert isinstance(task, DSNTSkew)
        for field in ("skew_indices", "freeze_seg", "task_name", "t_a", "t_e", "covar",
                      "mse_weight", "log_penalty_weight", "model_name"):
            assert getattr(task, field) == getattr(jtask, field), (overrides, field)


def test_runner_trains_and_predicts_dsnt_skew_on_the_cpu(tmp_path):
    """runner.run(task=dsnt-skew) at 64^2, 4 stages, 2 epochs: every skew
    log key finite in the history, the metrics CSV and the JSONL log; the
    checkpoint's task name; the test metrics through val_metrics (loss logs
    and Dice); two predicted views with mu, mode and alpha (K, 2) per
    frame and the mode's mask as the prediction; the skewness processor's
    numbers, skewness.npy and its figure skewness_error.png with no
    processor or figure error; the eval-only branch loads the checkpoint
    and gives the same test metrics."""
    overrides = ["data=synthetic", "data.image_size=64", "data.n_patients=5", "task=dsnt-skew",
                 "task.model.kernels=[[3,3],[3,3],[3,3],[3,3]]",
                 "task.model.strides=[[1,1],[2,2],[2,2],[2,2]]",
                 "task.model.drop_block=true", "task.optim.name=adamw", "task.t_a=4",
                 "trainer.batch_size=4", "trainer.max_epochs=2", f"save_path={tmp_path}",
                 f"task.psm_path={tmp_path / 'psm.npz'}", "seed=4",
                 "data.results_processors=[instant_metrics, skewness]"]
    result = runner.run(overrides, device="cpu")
    history = result["history"]
    assert [row["epoch"] for row in history] == [0, 1]
    for row in history:
        for split in ("train", "val"):
            assert {f"{split}/{k}" for k in SKEW_LOGS} <= set(row)
        assert all(np.isfinite(v) for v in row.values())
    ckpt = resolve_checkpoint(result["ckpt_path"])
    assert load_meta(ckpt)["task_name"] == "dsnt-skew"
    name = ckpt.name[:-len(".ckpt")]
    header = (ckpt.parent / f"{name}_metrics.csv").read_text().splitlines()[0].split(",")
    assert {f"train/{k}" for k in SKEW_LOGS} <= set(header)
    records = [json.loads(line) for line in
               (ckpt.parent / f"{name}_metrics.jsonl").read_text().splitlines()]
    assert len(records) == 2 and {f"val/{k}" for k in SKEW_LOGS} <= set(records[-1])
    test = result["test_metrics"]
    assert set(test) == {f"test/{k}" for k in SKEW_LOGS | {"dice"}}
    assert all(np.isfinite(v) for v in test.values())

    views = result["predict"]
    assert len(views) == 2 and "processor_errors" not in result
    for view in views:
        assert view.mu.shape == view.mode.shape == view.alpha.shape == (2, 21, 2)
        assert view.contour_samples.shape == (2, 1, 4, 21, 2)
        assert np.isfinite(view.uncertainty_map).all() and view.pred.shape == (2, 64, 64)
        assert not np.array_equal(view.mode, view.mu)
    metrics = json.loads((tmp_path / "results" / "metrics.json").read_text())
    assert {"skewness/error_skew_x", "skewness/error_skew_y",
            "skewness/mean_alpha_norm"} <= set(metrics)
    saved = np.load(tmp_path / "results" / "skewness.npy", allow_pickle=True).item()
    assert saved["errors"].shape == saved["average_skew"].shape == (4, 21, 2)
    assert (tmp_path / "results" / "skewness_error.png").stat().st_size > 0
    assert "figure_errors" not in metrics

    evaluated = runner.run(overrides + ["train=false", "predict=false"], device="cpu")
    assert evaluated["ckpt_path"] == str(ckpt)
    for key, value in test.items():
        np.testing.assert_allclose(evaluated["test_metrics"][key], value, rtol=1e-6)
