"""Experiment driver: compose config -> data -> task -> trainer -> test -> predict.

Counterpart of contouring_uncertainty_tpu/runner.py on one device:

    python -m contouring_uncertainty_torch.runner data=synthetic \\
        task.model.drop_block=true trainer.max_epochs=3 [--device=cpu]

`run` trains (or, with `train=false`, loads a port checkpoint from
`weights`, `ckpt` or the run's own best checkpoint), takes the best
weights, computes the test-split metrics through the task's `val_metrics`,
and runs the serving path (`predict.run_predict`) on them, which then runs
the data config's results processors into `<save_path>/results/`. The
device is cuda unless `device="cpu"` (`--device=cpu` on the command line)
is given. A processor that fails is recorded in `result["processor_errors"]`;
an eval-only run (`train=false`) with a failed processor or test pass exits
non-zero from `main`.

Not ported (ROADMAP.md Queue 1): `train_ensemble` and ensemble
directories, several devices (`predict_mesh`, `predict_sample_parallel`),
`predict_batch_views` > 1, the sequence sampler and soft masks.
"""

from __future__ import annotations

import sys
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from contouring_uncertainty_torch.config import compose
from contouring_uncertainty_torch.device import DeviceLike, resolve_device
from contouring_uncertainty_torch.factory import (
    build_data,
    build_task,
    build_trainer,
    experiment_name,
)
from contouring_uncertainty_torch.predict import check_predict_options, run_predict
from contouring_uncertainty_torch.train.checkpoint import resolve_checkpoint, restore_checkpoint


def _check_ported(cfg: Dict):
    if int(cfg.get("task", {}).get("train_ensemble", 0) or 0) > 1:
        raise NotImplementedError("deep ensembles are not ported yet "
                                  "(ROADMAP.md Queue 1, item 5)")
    if int(cfg.get("predict_batch_views", 1) or 1) > 1:
        raise NotImplementedError("predict_batch_views > 1 is not ported yet "
                                  "(ROADMAP.md Queue 1, item 3)")
    check_predict_options(cfg.get("task", {}))
    if int(cfg.get("predict_sample_parallel", 1) or 1) > 1:
        raise NotImplementedError("multi-device predict is not ported yet "
                                  "(ROADMAP.md Queue 1, item 11)")


def run(overrides: Optional[List[str]] = None, device: DeviceLike = None) -> Dict:
    device = resolve_device(device)
    cfg = compose(overrides)
    _check_ported(cfg)
    data = build_data(cfg)
    task = build_task(cfg, data.data_params)
    trainer = build_trainer(cfg, task, device=device)
    run_dir = Path(cfg.get("save_path", "outputs")) / str(cfg.get("seed", 10))

    result: Dict = {"cfg": cfg}
    if cfg.get("train", True):
        resume_from = None
        if cfg.get("resume"):
            resume_from = cfg.get("ckpt") or str(run_dir / (experiment_name(cfg) + "_last.ckpt"))
        params, ckpt_path = trainer.fit(data.train_arrays("train"), data.train_arrays("val"),
                                        resume_from=resume_from)
        model = trainer.model
        result["history"] = trainer.history
    else:
        ckpt_path = resolve_checkpoint(cfg.get("weights") or cfg.get("ckpt")
                                       or run_dir / (experiment_name(cfg) + ".ckpt"))
        params = restore_checkpoint(ckpt_path, map_location=device)["params"]
        model = task.build_model(device=device)
    model.load_state_dict(params)
    model.eval()
    result["ckpt_path"] = str(ckpt_path)

    if cfg.get("test", True):
        try:
            result["test_metrics"] = evaluate_split(
                task, model, data.train_arrays("test"),
                cfg.get("trainer", {}).get("batch_size", 32), device)
            print({k: round(v, 4) for k, v in result["test_metrics"].items()})
        except Exception as exc:  # recorded: an eval-only run then exits non-zero
            result["test_error"] = f"{type(exc).__name__}: {exc}"
            traceback.print_exc()
            print(f"[runner] test pass failed: {result['test_error']}")

    if cfg.get("predict", True):
        proc_metrics: Dict = {}
        result["predict"] = run_predict(task, model, data, cfg, device=device,
                                        metrics_out=proc_metrics)
        if proc_metrics.get("processor_errors"):
            result["processor_errors"] = proc_metrics["processor_errors"]
    return result


@torch.no_grad()
def evaluate_split(task, model, arrays: Dict[str, np.ndarray], batch_size: int,
                   device: torch.device) -> Dict[str, float]:
    """Mean of the task's `val_metrics` over the split's batches, in order."""
    from contouring_uncertainty_torch.train.trainer import _iterate, _to_device

    logs = [task.val_metrics(model, _to_device(batch, device))
            for batch in _iterate(arrays, batch_size, np.random.default_rng(0),
                                  shuffle=False, drop_last=False)]
    return {f"test/{k}": float(np.mean([float(l[k]) for l in logs])) for k in logs[0]}


def main(argv: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    for arg in [a for a in argv if a.startswith("--device=")]:
        device = arg.split("=", 1)[1]
        argv.remove(arg)
    result = run(argv, device=device)
    if result.get("history"):
        last = result["history"][-1]
        print({k: round(v, 4) for k, v in last.items() if isinstance(v, float)})
    print(f"checkpoint: {result['ckpt_path']}")
    # Eval-only runs exist to produce results: a failed processor or test
    # pass means the run did not deliver them.
    failures = {}
    if result.get("processor_errors"):
        failures["processors"] = result["processor_errors"]
    if result.get("test_error"):
        failures["test"] = result["test_error"]
    if not result["cfg"].get("train", True) and failures:
        print(f"[runner] evaluation produced errors: {failures}")
        sys.exit(1)


if __name__ == "__main__":
    main()
