"""Config -> objects: data source, task, trainer, experiment name.

Counterpart of contouring_uncertainty_tpu/factory.py for what the port
implements. `camus-cont` and `camus` read a CAMUS-layout HDF5 file
(`CamusContourData`); `synthetic` reads `data.dataset_path` where the caller
names an existing file other than the group's shared default, and otherwise
the films the JAX package would write there, from memory
(`data/synthetic.py synthetic_camus_data`), their landmarks extracted from
the masks in both cases; `lung` and `lung-cont` build `JSRTContourData` on
`data.dataset_path`, labelled with `LungLabel` (default [BG, LUNG, HEART]),
with no generated stand-in for a missing file. The tasks are every task of
the JAX factory: `dsnt-al`, `dsnt-skew` (`dsnt-skew5`, `dsnt-skew9`),
`epistemic`, and the segmentation baselines `mcdropout`, `aleatoric`,
`tta` and `ssn`, on every backbone of `models.build_backbone`.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

from contouring_uncertainty_torch.config.compose import CONFIG_DIR, ENV_RE
from contouring_uncertainty_torch.device import DeviceLike
from contouring_uncertainty_torch.models import as_dtype, check_backbone
from contouring_uncertainty_torch.train import Trainer, TrainerConfig

_SKEW_TASKS = ("dsnt-skew", "dsnt-skew5", "dsnt-skew9")


def shared_synthetic_path() -> str:
    """`data=synthetic`'s default `dataset_path` (the fallback of its
    `${env:SYNTH_DATA_PATH,...}`): one fixed file that every run on a
    machine meets, which may hold another run's films. The port never reads
    it; it reads a synthetic file only where the caller names another."""
    raw = json.loads((CONFIG_DIR / "data" / "synthetic.json").read_text())["dataset_path"]
    return ENV_RE.fullmatch(raw).group(2)


def build_data(cfg: Dict):
    from contouring_uncertainty_torch.data.camus import CamusContourData
    from contouring_uncertainty_torch.data.config import Label, LungLabel
    from contouring_uncertainty_torch.data.transforms import build_transform

    data_cfg = cfg["data"]
    name = data_cfg.get("name", "camus-cont")
    # Each dataset family has its own label enum.
    enum = LungLabel if name.startswith("lung") else Label
    default_labels = ["BG", "LUNG", "HEART"] if enum is LungLabel else ["BG", "LV"]
    labels = tuple(enum[l] if isinstance(l, str) else enum(l)
                   for l in data_cfg.get("labels") or default_labels)
    transform = build_transform(data_cfg.get("transform"))
    camus_kw = dict(fold=data_cfg.get("fold", 5),
                    points_per_side=data_cfg.get("points_per_side", 11), labels=labels,
                    transform=transform)
    if name == "synthetic":
        from contouring_uncertainty_torch.data.synthetic import synthetic_camus_data

        path = data_cfg.get("dataset_path")
        if path and str(path) != shared_synthetic_path() and Path(path).exists():
            return CamusContourData(path, **camus_kw)
        # The films the JAX package writes to a missing `dataset_path`, read
        # from memory (no h5py needed).
        return synthetic_camus_data(n_patients=data_cfg.get("n_patients", 16),
                                    size=data_cfg.get("image_size", 256),
                                    seed=cfg.get("seed", 10), **camus_kw)
    if name in ("camus-cont", "camus"):
        return CamusContourData(data_cfg["dataset_path"],
                                use_sequence=data_cfg.get("use_sequence", False), **camus_kw)
    if name in ("lung", "lung-cont"):
        from contouring_uncertainty_torch.data.lung import JSRTContourData

        return JSRTContourData(data_cfg["dataset_path"], labels=labels, transform=transform)
    raise ValueError(f"Unknown data config '{name}'")


def model_kwargs_from_cfg(model_cfg: Dict) -> Dict:
    kwargs = {}
    if "kernels" in model_cfg:
        kwargs["kernels"] = tuple(tuple(k) for k in model_cfg["kernels"])
    if "strides" in model_cfg:
        kwargs["strides"] = tuple(tuple(s) for s in model_cfg["strides"])
    for flag in ("drop_block", "deep_supervision", "residual", "attention",
                 "out_seg_bias", "ssn_rank", "bottleneck_out", "init_channels",
                 "dropout", "n_heads", "base", "layers", "encoder_relu",
                 "decoder_relu", "sigma_out"):
        if flag in model_cfg:
            kwargs[flag] = model_cfg[flag]
    if "layers" in kwargs:
        kwargs["layers"] = tuple(kwargs["layers"])
    if "dtype" in model_cfg:
        kwargs["dtype"] = as_dtype(model_cfg["dtype"])
    return kwargs


def build_task(cfg: Dict, data_params):
    from contouring_uncertainty_torch import tasks

    task_cfg = cfg["task"]
    name = task_cfg.get("name", "dsnt-al")
    model_cfg = task_cfg.get("model", {})
    common = dict(
        data_params=data_params,
        t_a=task_cfg.get("t_a", 25),
        t_e=task_cfg.get("t_e", 1),
        model_kwargs=model_kwargs_from_cfg(model_cfg),
        model_name=model_cfg.get("name", "unet2"),
    )
    check_backbone(common["model_name"])
    weights = dict(mse_weight=task_cfg.get("mse_weight", 1.0),
                   log_penalty_weight=task_cfg.get("log_penalty_weight", 1.0))
    if name == "dsnt-al":
        return tasks.DSNTAleatoric(covar=task_cfg.get("covar", True), **weights, **common)
    if name in _SKEW_TASKS:
        raw_idx = task_cfg.get("skew_indices")
        return tasks.DSNTSkew(skew_indices=tuple(raw_idx) if raw_idx else None,
                              freeze_seg=task_cfg.get("freeze_seg", False), **weights,
                              **common)
    if name == "epistemic":
        return tasks.EpistemicUncertainty(covar=task_cfg.get("covar", True), **common)
    if name == "mcdropout":
        return tasks.McDropoutUncertainty(**common)
    if name == "aleatoric":
        return tasks.AleatoricUncertainty(iterations=task_cfg.get("iterations", 10), **common)
    if name == "tta":
        return tasks.TTAUncertainty(**common)
    if name == "ssn":
        return tasks.StochasticSegmentationNetwork(rank=task_cfg.get("rank", 10),
                                                   mc_samples=task_cfg.get("mc_samples", 20),
                                                   **common)
    raise ValueError(f"Unknown task '{name}'")


def experiment_name(cfg: Dict) -> str:
    data_name = cfg["data"].get("name", "data")
    task_name = cfg["task"].get("name", "task")
    model_name = cfg["task"].get("model", {}).get("name", "unet2")
    drop = cfg["task"].get("model", {}).get("drop_block", False)
    return f"{data_name}_{task_name}-{model_name}-{drop}_{cfg.get('seed', 10)}"


def build_trainer(cfg: Dict, task, device: DeviceLike = None) -> Trainer:
    """The trainer of a composed config, on `device` (default cuda)."""
    t = cfg.get("trainer", {})
    optim = cfg["task"].get("optim", {})
    tc = TrainerConfig(
        batch_size=t.get("batch_size", 32),
        max_epochs=t.get("max_epochs", 1000),
        patience=t.get("patience", 100),
        lr=float(optim.get("lr", 1e-3)),
        weight_decay=float(optim.get("weight_decay", 1e-3)),
        optimizer=optim.get("name", "adamw"),
        momentum=float(optim.get("momentum", 0.0) or 0.0),
        rmsprop_alpha=float(optim.get("alpha", 0.9)),
        lr_schedule=optim.get("schedule"),
        lr_decay_steps=int(optim.get("decay_steps", 0) or 0),
        lr_decay_rate=float(optim.get("decay_rate", 0.1)),
        lr_warmup_steps=int(optim.get("warmup_steps", 0) or 0),
        seed=cfg.get("seed", 10),
        save_path=cfg.get("save_path", "outputs"),
        name=experiment_name(cfg),
        fast_dev_run=t.get("fast_dev_run", 0),
        augment=t.get("augment", True),
        min_epochs=t.get("min_epochs", 1),
        use_comet=bool(cfg.get("comet", False)),
        use_tensorboard=bool(cfg.get("tensorboard", False)),
        save_every=t.get("save_every", 25),
        feed_uint8=bool(t.get("feed_uint8", False)),
    )
    return Trainer(task, tc, device=device)
