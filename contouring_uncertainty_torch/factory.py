"""Config -> objects: data source, task, trainer, experiment name.

Counterpart of contouring_uncertainty_tpu/factory.py for what the port
implements. `synthetic` builds the in-memory `SyntheticContourData`
(where the JAX package writes and reads a CAMUS-layout HDF5 file); only the
`dsnt-al` task exists. Anything else raises, naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Dict

from contouring_uncertainty_torch.device import DeviceLike
from contouring_uncertainty_torch.models import as_dtype
from contouring_uncertainty_torch.train import Trainer, TrainerConfig

# Config names the JAX factory builds and the port does not yet, with
# where ROADMAP.md Queue 1 lists them.
_DATA_NOT_PORTED = {"camus-cont": 2, "camus": 2, "lung": 10, "lung-cont": 10}
_TASKS_NOT_PORTED = {"dsnt-skew": 6, "dsnt-skew5": 6, "dsnt-skew9": 6, "epistemic": 7,
                     "mcdropout": 8, "aleatoric": 8, "tta": 8, "ssn": 8}


def build_data(cfg: Dict):
    from contouring_uncertainty_torch.data.synthetic import SyntheticContourData
    from contouring_uncertainty_torch.data.transforms import build_transform

    data_cfg = cfg["data"]
    name = data_cfg.get("name", "camus-cont")
    if name in _DATA_NOT_PORTED:
        raise NotImplementedError(f"data '{name}' is not ported yet "
                                  f"(ROADMAP.md Queue 1, item {_DATA_NOT_PORTED[name]})")
    if name != "synthetic":
        raise ValueError(f"Unknown data config '{name}'")
    labels = data_cfg.get("labels") or ["BG", "LV"]
    if [str(label) for label in labels] != ["BG", "LV"]:
        raise NotImplementedError(f"synthetic data has the labels [BG, LV], got {labels}")
    return SyntheticContourData(
        n_patients=data_cfg.get("n_patients", 16),
        k=2 * data_cfg.get("points_per_side", 11) - 1,
        size=data_cfg.get("image_size", 256),
        seed=cfg.get("seed", 10),
        transform=build_transform(data_cfg.get("transform")))


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
    task_cfg = cfg["task"]
    name = task_cfg.get("name", "dsnt-al")
    if name in _TASKS_NOT_PORTED:
        raise NotImplementedError(f"task '{name}' is not ported yet "
                                  f"(ROADMAP.md Queue 1, item {_TASKS_NOT_PORTED[name]})")
    if name != "dsnt-al":
        raise ValueError(f"Unknown task '{name}'")
    from contouring_uncertainty_torch.tasks import DSNTAleatoric

    model_cfg = task_cfg.get("model", {})
    return DSNTAleatoric(
        data_params=data_params,
        covar=task_cfg.get("covar", True),
        mse_weight=task_cfg.get("mse_weight", 1.0),
        log_penalty_weight=task_cfg.get("log_penalty_weight", 1.0),
        t_a=task_cfg.get("t_a", 25),
        t_e=task_cfg.get("t_e", 1),
        model_kwargs=model_kwargs_from_cfg(model_cfg),
        model_name=model_cfg.get("name", "unet2"),
    )


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
