"""Experiment driver: compose config -> data -> task -> trainer -> test -> predict.

Counterpart of contouring_uncertainty_tpu/runner.py on one device:

    python -m contouring_uncertainty_torch.runner data=synthetic \\
        task.model.drop_block=true trainer.max_epochs=3 [--device=cpu]

`run` trains (or, with `train=false`, loads a port checkpoint from
`weights`, `ckpt` or the run's own best checkpoint, a local path or a
Comet model-registry query), takes the best weights, computes the
test-split metrics through the task's `val_metrics`, and runs the serving
path (`predict.run_predict`) on them, which then runs the data config's
results processors into `<save_path>/results/`.

`task.train_ensemble=M` (M > 1) trains a deep ensemble as the JAX runner
does: member i with seed + i (its own run directory and experiment name),
its best checkpoint moved to
`<save_path>/<seed>/<name>_ensemble/member_i.ckpt`; `history` is the last
member's and `ckpt_path` the directory. A checkpoint directory without
`state.pt` is loaded as an ensemble of its `*.ckpt` members in sorted
order (lexicographic: member_10 before member_2), as the JAX runner loads
it. An ensemble is served with T_e = M and its test metrics are member
0's. The
device is cuda unless `device="cpu"` (`--device=cpu` on the command line)
is given. A processor that fails is recorded in `result["processor_errors"]`;
an eval-only run (`train=false`) with a failed processor or test pass exits
non-zero from `main`.

`data=camus-cont` and `data=camus` read a CAMUS-layout HDF5 file from
`data.dataset_path`; `data=lung-cont` and `data=lung` read JSRT films from
it (pass a `task.psm_path` of their own). `task.sequence_sampler`,
`task.seq_psm_path`, `task.soft_mask` and `predict_batch_views` reach
`run_predict`. `predict_mesh` is read as the JAX runner reads it (a value
it refuses raises ValueError before training); with several visible GPUs
the port still serves on one and says so. Not ported (ROADMAP.md Queue 1,
item 11): serving on several devices (`predict_sample_parallel`, the view
mesh of `predict_mesh`).
"""

from __future__ import annotations

import copy
import shutil
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
    """Raise, before anything is built, on run options the port does not
    have yet, and on a `predict_mesh` value the JAX runner refuses."""
    check_predict_options(cfg)


def run(overrides: Optional[List[str]] = None, device: DeviceLike = None) -> Dict:
    device = resolve_device(device)
    cfg = compose(overrides)
    _check_ported(cfg)
    data = build_data(cfg)
    task = build_task(cfg, data.data_params)
    trainer = build_trainer(cfg, task, device=device)
    run_dir = Path(cfg.get("save_path", "outputs")) / str(cfg.get("seed", 10))

    result: Dict = {"cfg": cfg}
    n_members = int(cfg.get("task", {}).get("train_ensemble", 0) or 0)
    if cfg.get("train", True) and n_members > 1:
        model, ckpt_path, result["history"] = train_ensemble(cfg, task, data, n_members,
                                                             device)
    elif cfg.get("train", True):
        resume_from = None
        if cfg.get("resume"):
            resume_from = cfg.get("ckpt") or str(run_dir / (experiment_name(cfg) + "_last.ckpt"))
        params, ckpt_path = trainer.fit(data.train_arrays("train"), data.train_arrays("val"),
                                        resume_from=resume_from)
        model = trainer.model
        model.load_state_dict(params)
        result["history"] = trainer.history
    else:
        ckpt_path = resolve_checkpoint(cfg.get("weights") or cfg.get("ckpt")
                                       or run_dir / (experiment_name(cfg) + ".ckpt"))
        model = load_weights(task, ckpt_path, device)
    model = [m.eval() for m in model] if isinstance(model, list) else model.eval()
    result["ckpt_path"] = str(ckpt_path)

    if cfg.get("test", True):
        try:
            result["test_metrics"] = evaluate_split(
                task, model[0] if isinstance(model, list) else model, data.train_arrays("test"),
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


def train_ensemble(cfg: Dict, task, data, n_members: int, device: torch.device):
    """Train `n_members` members (member i with seed + i) into
    `<save_path>/<seed>/<name>_ensemble/member_i.ckpt`. Returns the members
    with their best weights, the directory and the last member's history."""
    seed = cfg.get("seed", 10)
    ens_dir = Path(cfg.get("save_path", "outputs")) / str(seed) / (
        experiment_name(cfg) + "_ensemble")
    ens_dir.mkdir(parents=True, exist_ok=True)
    train_arrays, val_arrays = data.train_arrays("train"), data.train_arrays("val")
    members = []
    for i in range(n_members):
        member_trainer = build_trainer({**cfg, "seed": seed + i}, task, device=device)
        params, member_ckpt = member_trainer.fit(train_arrays, val_arrays)
        target = ens_dir / f"member_{i}.ckpt"
        if target.exists():
            shutil.rmtree(target)
        shutil.move(str(member_ckpt), str(target))
        member_trainer.model.load_state_dict(params)
        members.append(member_trainer.model)
    return members, ens_dir, member_trainer.history


def load_weights(task, ckpt_path: Path, device: torch.device):
    """The task's model with a checkpoint's weights, or, for a directory
    without `state.pt`, the deep ensemble of its `*.ckpt` members in sorted
    order (as the JAX runner globs them)."""
    ckpt_path = Path(ckpt_path)
    members = (sorted(ckpt_path.glob("*.ckpt"))
               if ckpt_path.is_dir() and not (ckpt_path / "state.pt").exists() else [])
    base = task.build_model(device=device)
    models = []
    for path in members or [ckpt_path]:
        model = copy.deepcopy(base) if models else base  # one initialisation for all
        model.load_state_dict(restore_checkpoint(path, map_location=device)["params"])
        models.append(model)
    return models if members else models[0]


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
