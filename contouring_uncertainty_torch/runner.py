"""Experiment driver: compose config -> data -> task -> trainer -> test -> predict.

Counterpart of contouring_uncertainty_tpu/runner.py:

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
`run_predict`.

Several GPUs, one process each (parallel/): `main` on a machine with more
than one visible GPU starts one worker per GPU (`distributed.spawn`);
under torchrun (or a SLURM step) each process joins the group it finds.
Then `run` trains data-parallel over every rank (`train.Trainer`), takes
the test metrics over every rank's rows of each batch, and serves as the
JAX runner does: with `predict_mesh` auto (also true, 1, yes, on) on a mesh
of every rank, `predict_sample_parallel` = s of them on each view's sample
chain (s must divide the ranks, else ValueError before training; with one
rank s is ignored); with `predict_mesh=false` rank 0 serves alone. Rank 0
returns the predictions, runs the processors and writes the files; the
other ranks return an empty `predict` list.
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
from contouring_uncertainty_torch.parallel.distributed import (
    initialize,
    rank,
    rank0_first,
    spawn,
)
from contouring_uncertainty_torch.parallel.mesh import global_means, make_mesh, shard_batch
from contouring_uncertainty_torch.predict import check_predict_options, predict_mesh, run_predict
from contouring_uncertainty_torch.train.checkpoint import resolve_checkpoint, restore_checkpoint


def run(overrides: Optional[List[str]] = None, device: DeviceLike = None) -> Dict:
    device = resolve_device(device)
    cfg = compose(overrides)
    check_predict_options(cfg)  # before anything is built
    data = rank0_first(lambda: build_data(cfg))  # rank 0 fills the data's caches
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
            if rank() == 0:
                print({k: round(v, 4) for k, v in result["test_metrics"].items()})
        except Exception as exc:  # recorded: an eval-only run then exits non-zero
            result["test_error"] = f"{type(exc).__name__}: {exc}"
            traceback.print_exc()
            print(f"[runner] test pass failed: {result['test_error']}")

    if cfg.get("predict", True):
        proc_metrics: Dict = {}
        mesh = predict_mesh(cfg)
        result["predict"] = [] if mesh is None and rank() != 0 else run_predict(
            task, model, data, cfg, device=device, metrics_out=proc_metrics, mesh=mesh)
        if proc_metrics.get("processor_errors"):
            result["processor_errors"] = proc_metrics["processor_errors"]
    return result


def train_ensemble(cfg: Dict, task, data, n_members: int, device: torch.device):
    """Train `n_members` members (member i with seed + i) into
    `<save_path>/<seed>/<name>_ensemble/member_i.ckpt`, each data-parallel
    over every rank (rank 0 moves the checkpoints). Returns the members
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
        if rank() == 0:
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
    """Mean of the task's `val_metrics` over the split's batches, in order.
    On several ranks each computes its rows of every batch (`shard_batch`)
    and the batch means are taken over the ranks (`global_means`), as the
    JAX runner's test pass runs on its mesh."""
    from contouring_uncertainty_torch.train.trainer import _iterate, _to_device

    mesh = make_mesh()
    logs = [task.val_metrics(model, _to_device(shard_batch(batch, mesh), device))
            for batch in _iterate(arrays, batch_size, np.random.default_rng(0),
                                  shuffle=False, drop_last=False)]
    logs = global_means(logs, mesh)
    return {f"test/{k}": float(np.mean([l[k] for l in logs])) for k in logs[0]}


def _main(device: DeviceLike, argv: List[str]) -> int:
    """`run` and its report (printed by rank 0); the exit code."""
    result = run(argv, device=device)
    if rank() == 0:
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
        return 1
    return 0


def main(argv: Optional[List[str]] = None):
    """The command line: `run` on `--device` (default cuda). A process that
    torchrun or a SLURM step started joins its process group; a plain
    command on a machine with several GPUs starts one worker per GPU
    (`distributed.spawn`, NCCL) and exits with the worst worker's code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    for arg in [a for a in argv if a.startswith("--device=")]:
        device = arg.split("=", 1)[1]
        argv.remove(arg)
    joined = initialize(device=device)
    if not joined and resolve_device(device).type == "cuda" and torch.cuda.device_count() > 1:
        code = max(spawn(_main, torch.cuda.device_count(), args=(argv,)))
    else:
        code = _main(device, argv)
    if code:
        sys.exit(code)


if __name__ == "__main__":
    main()
