"""Trainer: train and eval steps, the epoch loop, early stopping, checkpoints.

Counterpart of contouring_uncertainty_tpu/train/trainer.py:

- `train_step`: uint8 feed dequantised on the device, augmentation
  (data/augment.py), the task's loss with dropout on, backward, one
  optimizer update; `eval_step`: the task's `val_metrics` without
  gradients;
- optimizers and learning-rate schedules follow optax's rules, as the JAX
  trainer builds them (`_make_optimizer`, `_lr_schedule`): AdamW with
  decoupled decay; Adam, SGD and RMSprop with the decay added to the
  gradient first; the schedule read at the update count before its
  increment; the parameters a task labels "freeze" (`optimizer_labels`,
  dsnt-skew's `freeze_seg`) are left out of the optimizer and take no
  gradient, so they stay as they are, as under optax's set_to_zero;
- `fit`: epochs of batches drawn as the JAX trainer draws them: by the C++
  prefetcher outside `fast_dev_run` (`data/native_loader.py`,
  `std::mt19937_64(seed + epoch)` and `std::shuffle` over the indices,
  drop_last; fewer training frames than `batch_size` is a ValueError), or,
  under `fast_dev_run` or where the library cannot be built, by `_iterate`
  (one `np.random.default_rng(seed)` permutation per epoch); fed to the device
  by a background thread through pinned host memory (`_device_prefetch`),
  the wait for each batch timed as the `data` phase; divergence abort,
  best-weights copy, early stopping on val/loss, one CSV row per epoch
  with the JAX column names, the JSONL log and its Comet and TensorBoard
  back ends (`use_comet`, `use_tensorboard`: train/logging.py), a periodic
  resumable `{name}_last.ckpt`, the best `{name}.ckpt`, `train_complete`
  and `{name}_phases.json`.

A model in bf16 (`task.model.dtype=bfloat16`) trains as the JAX package's
does: f32 parameters and AdamW state, convolutions in bf16 (weights cast
per call), instance-norm statistics in f32; the UNet's head computes in f32
(the wider of the trunk's and the head's dtypes), so the moments and the
loss see f32 logits.

On the card the augmentation and dropout draws come from one generator on
the card (seeded with the run's seed), so no mask is drawn on the host.
They are not JAX's draws (`fold_in(rng, 2*step)` and `2*step + 1`): runs
agree with the JAX trainer in distribution, not value by value.

Data parallel over every rank of the process group (`mesh`, by default
`parallel.mesh.make_mesh()`, all of it on the data axis), one process per
GPU, as the JAX trainer averages gradients over its mesh's data axis.
`batch_size` is the global batch: every rank builds the same global
batches (the same seeds) and keeps its `process_batch_slice` rows (a
global batch that does not divide the ranks is a ValueError); it draws
the augmentation parameters and dropout masks of the whole batch from the
same generator and keeps its rows (`rng.RowBlock`), so the ranks together
compute one process's step up to the order of the sums. The gradients are
averaged over the data axis (one all-reduce per step), the logs averaged
over it, so every rank takes the same early-stopping, best-weights and
divergence decisions. Rank 0 alone writes the checkpoints, the metrics
CSV and JSONL, the summary and the phases file.

Not ported (ROADMAP.md Queue 1, item 13): the per-epoch validation figures
of the JAX trainer's `log_figures` (the tasks' `val_figure`).
"""

from __future__ import annotations

import csv
import itertools
import math
import queue
import threading
import time
from contextlib import closing
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from contouring_uncertainty_torch.data import augment as aug
from contouring_uncertainty_torch.data.camus import iterate_batches
from contouring_uncertainty_torch.data.config import Tags
from contouring_uncertainty_torch.device import DeviceLike, resolve_device
from contouring_uncertainty_torch.parallel.distributed import process_batch_slice
from contouring_uncertainty_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    global_means,
    make_mesh,
    replicate,
)
from contouring_uncertainty_torch.rng import row_block
from contouring_uncertainty_torch.train.checkpoint import (
    load_meta,
    restore_checkpoint,
    save_checkpoint,
)
from contouring_uncertainty_torch.train.logging import ExperimentLogger
from contouring_uncertainty_torch.utils.profiling import PhaseTimer, model_summary


@dataclass
class TrainerConfig:
    batch_size: int = 32
    max_epochs: int = 1000
    patience: int = 100
    lr: float = 1e-3
    weight_decay: float = 1e-3
    # "adamw" (decoupled decay) or "adam" / "sgd" / "rmsprop" (decay added
    # to the gradient before the moment updates), as the JAX trainer.
    optimizer: str = "adamw"
    momentum: float = 0.0  # sgd / rmsprop
    rmsprop_alpha: float = 0.9  # rmsprop smoothing
    # None | constant | cosine | exponential | step, per optimizer step;
    # horizon lr_decay_steps (0 -> max_epochs * 100), linear warmup prefix.
    lr_schedule: Optional[str] = None
    lr_decay_steps: int = 0
    lr_decay_rate: float = 0.1
    lr_warmup_steps: int = 0
    seed: int = 10
    save_path: str = "outputs"
    name: str = "run"
    fast_dev_run: int = 0  # >0: cap batches per epoch and run 1 epoch
    augment: bool = True
    min_epochs: int = 1
    # Ship train images as uint8 (lossless for 8-bit data in [0, 1]); the
    # step dequantises them on the device.
    feed_uint8: bool = False
    use_comet: bool = False
    use_tensorboard: bool = False
    save_every: int = 25  # periodic resumable checkpoint, in epochs


def _constant(value: float) -> Callable[[int], float]:
    return lambda count: value


def _cosine(init: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(init, decay_steps) (alpha 0, exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine schedule needs positive decay steps, got {decay_steps}")
    return lambda count: init * 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps)
                                                      / decay_steps))


def _exponential(init: float, steps: int, rate: float,
                 staircase: bool = False) -> Callable[[int], float]:
    """optax.exponential_decay(init, steps, rate, staircase=...)."""
    if steps <= 0 or rate == 0:
        return _constant(init)

    def schedule(count):
        p = count / steps
        if staircase:
            p = math.floor(p)
        return init if count <= 0 else init * rate ** p

    return schedule


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule(init, end, steps)."""
    if steps <= 0:
        return _constant(init)
    return lambda count: (init - end) * (1.0 - min(max(count, 0), steps) / steps) + end


def _join(first: Callable, second: Callable, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules([first, second], [boundary]): the second one
    counts from the boundary."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop(lr, decay, momentum) without centring or bias
    correction: nu = decay*nu + (1-decay)*g^2; u = -lr * g / sqrt(nu + eps)
    (eps inside the root); with momentum, t = u + momentum*t and the update
    is t (the trace follows the learning-rate scaling). torch.optim.RMSprop
    puts eps outside the root and scales by lr after its momentum buffer,
    so it is not used. `weight_decay` is added to the gradient first."""

    def __init__(self, params, lr: float, alpha: float = 0.9, eps: float = 1e-8,
                 momentum: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay, lr = group["alpha"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    state["trace"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1.0 - decay) * (g * g) + decay * nu)
                update = -lr * (torch.rsqrt(nu + group["eps"]) * g)
                trace = state["trace"]
                trace.copy_(update + group["momentum"] * trace)
                p.add_(trace)


class Trainer:
    def __init__(self, task, config: TrainerConfig, device: DeviceLike = None,
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.task = task
        self.config = config
        self.mesh = mesh if mesh is not None else make_mesh()
        if self.mesh.shape[MODEL_AXIS] != 1:
            raise ValueError(f"the trainer is data parallel over every rank: its mesh "
                             f"{self.mesh.shape} needs model_parallel=1")
        self.model: Optional[torch.nn.Module] = None  # built by init_state
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.generator: Optional[torch.Generator] = None
        self.history: list = []
        self._metrics_file: Optional[Path] = None
        self._schedule = self._lr_schedule()

    # ------------------------------------------------------------------- setup

    def _lr_schedule(self) -> Callable[[int], float]:
        """Per-step learning rate (also logged as `lr` each epoch)."""
        cfg = self.config
        name = (cfg.lr_schedule or "").lower()
        horizon = cfg.lr_decay_steps or cfg.max_epochs * 100
        if not name or name == "constant":
            sched = _constant(cfg.lr)
        elif name == "cosine":
            sched = _cosine(cfg.lr, horizon)
        elif name == "exponential":
            sched = _exponential(cfg.lr, horizon, cfg.lr_decay_rate)
        elif name == "step":
            sched = _exponential(cfg.lr, horizon, cfg.lr_decay_rate, staircase=True)
        else:
            raise ValueError(f"Unknown lr_schedule '{cfg.lr_schedule}'")
        if cfg.lr_warmup_steps:
            sched = _join(_linear(0.0, cfg.lr, cfg.lr_warmup_steps), sched,
                          cfg.lr_warmup_steps)
        return sched

    def _make_optimizer(self, params) -> torch.optim.Optimizer:
        cfg = self.config
        name = cfg.optimizer.lower()
        # The schedule sets every group's lr before each update.
        lr = self._schedule(0)
        if name == "adamw":
            return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=cfg.weight_decay)
        if name == "adam":
            return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=cfg.weight_decay)
        if name == "sgd":
            return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum,
                                   weight_decay=cfg.weight_decay)
        if name == "rmsprop":
            return RMSprop(params, lr=lr, alpha=cfg.rmsprop_alpha, momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay)
        raise ValueError(f"Unknown optimizer '{cfg.optimizer}'")

    def init_state(self):
        """The task's model with weights from the run's seed (drawn on the
        CPU: the same weights on every device and rank; a rank whose weights
        differ from rank 0's raises), a fresh optimizer over the parameters
        the task does not freeze, and the generator of the run's
        augmentation and dropout draws on the trainer's device."""
        seed = self.config.seed
        self.model = self.task.build_model(device=self.device,
                                           generator=torch.Generator().manual_seed(seed))
        if not replicate(self.model, self.mesh):
            raise RuntimeError("the ranks built different initial weights from one seed")
        labels_fn = getattr(self.task, "optimizer_labels", None)
        labels = labels_fn(self.model) if labels_fn else None
        if labels is not None:
            for name, p in self.model.named_parameters():
                p.requires_grad_(labels[name] != "freeze")
        self.optimizer = self._make_optimizer(
            [p for p in self.model.parameters() if p.requires_grad])
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------- steps

    def _local(self, batch: Dict[str, torch.Tensor], train: bool):
        """(this rank's rows of a global batch, the generator of its draws:
        the run's generator cut to those rows). A training batch is cut by
        `process_batch_slice` (one that does not divide the ranks is JAX's
        ValueError), a validation batch by the mesh (a ragged one whole)."""
        n = len(batch[Tags.img])
        rows = process_batch_slice(n) if train else self.mesh.rows(n)
        return {k: v[rows] for k, v in batch.items()}, row_block(self.generator, rows, n)

    def train_step(self, batch: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        """One update on a global batch already on the device (this rank
        computes on its rows); `step` is the update count before this
        update (the schedule's argument). Returns this rank's loss logs,
        detached."""
        batch, generator = self._local(batch, train=True)
        img = batch[Tags.img]
        if img.dtype == torch.uint8:
            batch = {**batch, Tags.img: img.to(torch.float32) / 255.0}
        if self.config.augment:
            batch = aug.apply(batch, aug.sample_params(generator, img.shape[0]))
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, logs = self.task.loss(self.model, batch, generator=generator, train=True)
        loss.backward()
        self._average_gradients()
        self.apply_update(step)
        return {k: v.detach() for k, v in logs.items()}

    def _average_gradients(self):
        """Average the parameters' gradients over the mesh's data axis, in
        one all-reduce (no-op on one rank). Frozen parameters have none."""
        d = self.mesh.shape[DATA_AXIS]
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        if d == 1 or not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.mesh.group(DATA_AXIS))
        flat = flat / d
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def apply_update(self, step: int):
        """Apply the parameters' gradients with the learning rate of update
        `step` (optax reads its schedule at the count before the update)."""
        for group in self.optimizer.param_groups:
            group["lr"] = self._schedule(step)
        self.optimizer.step()

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The task's validation metrics over this rank's rows of a global
        batch (`parallel.mesh.global_means` averages them over the ranks)."""
        self.model.eval()
        return self.task.val_metrics(self.model, self._local(batch, train=False)[0])

    # --------------------------------------------------------------------- fit

    def fit(self, train_arrays: Dict[str, np.ndarray], val_arrays: Dict[str, np.ndarray],
            resume_from: Optional[str] = None):
        """Train. `resume_from` restores a resumable checkpoint written by
        the periodic saver (weights, optimizer state, update count, epoch).
        Returns (the best weights as a state dict, the best checkpoint's
        path); the model keeps the last weights."""
        cfg = self.config
        if cfg.feed_uint8:
            train_arrays = _quantize_images(train_arrays)
        np_rng = np.random.default_rng(cfg.seed)
        self.init_state()
        start_epoch = 0
        step = 0
        if resume_from:
            restored = restore_checkpoint(resume_from, map_location=self.device)
            self.model.load_state_dict(restored["params"])
            self.optimizer.load_state_dict(restored["opt_state"])
            step = int(restored["step"])
            start_epoch = int(load_meta(resume_from).get("epoch", -1)) + 1

        run_dir = Path(cfg.save_path) / str(cfg.seed)
        writer = self.mesh.rank == 0  # the one rank that writes files
        exp_logger = (ExperimentLogger(run_dir, cfg.name, use_comet=cfg.use_comet,
                                       use_tensorboard=cfg.use_tensorboard)
                      if writer else None)
        self._metrics_file = run_dir / f"{cfg.name}_metrics.csv"
        if writer and not cfg.fast_dev_run:
            (run_dir / "summary.txt").write_text(
                model_summary(self.model, self.task.data_params.in_shape))
        timer = PhaseTimer(sync=self.device.type == "cuda")

        best_val = np.inf
        best_params = _copy_state(self.model)
        best_epoch = -1
        epochs_since_best = 0
        max_epochs = 1 if cfg.fast_dev_run else cfg.max_epochs
        # The next batch is fed by a background thread while a step runs,
        # except in a fast_dev_run, which stops after a few batches.
        overlap = not cfg.fast_dev_run
        last_ckpt = run_dir / f"{cfg.name}_last.ckpt"
        prefetcher = None
        if not cfg.fast_dev_run:
            from contouring_uncertainty_torch.data.native_loader import NativePrefetcher

            try:
                prefetcher = NativePrefetcher(train_arrays, cfg.batch_size, seed=cfg.seed)
            except RuntimeError:  # no library: numpy batches, as the JAX trainer falls back
                prefetcher = None
        try:
            for epoch in range(start_epoch, max_epochs):
                t0 = time.time()
                train_logs = []
                batches = (prefetcher.epoch() if prefetcher is not None
                           else _iterate(train_arrays, cfg.batch_size, np_rng))
                if overlap:
                    batches = _device_prefetch(batches, self.device)
                with closing(batches):
                    for bi in itertools.count():
                        if cfg.fast_dev_run and bi >= cfg.fast_dev_run:
                            break
                        with timer.phase("data"):  # the wait for the next batch
                            batch = next(batches, None)
                            if batch is not None and not overlap:
                                batch = _to_device(batch, self.device)
                        if batch is None:
                            break
                        with timer.phase("train_step"):
                            train_logs.append(self.train_step(batch, step))
                        step += 1

                val_logs = []
                for bi, batch in enumerate(_iterate(val_arrays, cfg.batch_size, np_rng,
                                                    shuffle=False, drop_last=False)):
                    if cfg.fast_dev_run and bi >= cfg.fast_dev_run:
                        break
                    with timer.phase("eval_step"):
                        val_logs.append(self.eval_step(_to_device(batch, self.device)))

                train_logs = global_means(train_logs, self.mesh)
                val_logs = global_means(val_logs, self.mesh)
                # A whole epoch of non-finite losses: the run diverged; stop
                # and keep the best checkpoint.
                epoch_losses = np.array([l["loss"] for l in train_logs])
                if len(epoch_losses) and not np.isfinite(epoch_losses).any():
                    print(f"[trainer] aborting: all train losses non-finite at epoch {epoch}")
                    self.history.append({"epoch": epoch, "diverged": 1.0})
                    break

                # Keys sorted, as the JAX trainer's jitted steps return them.
                row = {"epoch": epoch, "time": time.time() - t0, "lr": float(self._schedule(step))}
                row.update({f"train/{k}": float(np.mean([l[k] for l in train_logs]))
                            for k in sorted(train_logs[0])})
                row.update({f"val/{k}": float(np.mean([l[k] for l in val_logs]))
                            for k in sorted(val_logs[0])})
                self.history.append(row)
                if writer:
                    self._log_row(row)
                    exp_logger.log_metrics(row, step=epoch)

                val_loss = row["val/loss"]
                if np.isfinite(val_loss) and val_loss < best_val:
                    best_val = val_loss
                    best_params = _copy_state(self.model)
                    best_epoch = epoch
                    epochs_since_best = 0
                else:
                    epochs_since_best += 1
                if writer and cfg.save_every and (epoch + 1) % cfg.save_every == 0:
                    save_checkpoint(
                        last_ckpt,
                        {"params": self.model.state_dict(),
                         "opt_state": self.optimizer.state_dict(), "step": step},
                        meta={"task_name": self.task.task_name, "epoch": epoch,
                              "seed": cfg.seed})
                if epochs_since_best > cfg.patience and epoch + 1 >= cfg.min_epochs:
                    break
        finally:
            if prefetcher is not None:
                prefetcher.close()
            if exp_logger is not None:
                exp_logger.close()
        ckpt_path = run_dir / f"{cfg.name}.ckpt"
        if writer:
            timer.dump(run_dir / f"{cfg.name}_phases.json")
            save_checkpoint(ckpt_path, {"params": best_params},
                            meta={"task_name": self.task.task_name, "best_epoch": best_epoch,
                                  "best_val_loss": float(best_val), "seed": cfg.seed})
            (run_dir / "train_complete").write_text("1")
        return best_params, ckpt_path

    def _log_row(self, row: Dict[str, Any]):
        new = not self._metrics_file.exists()
        with open(self._metrics_file, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(row))
            if new:
                writer.writeheader()
            writer.writerow(row)


def _copy_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _quantize_images(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """feed_uint8: [0, 1] images as uint8; refuses data mostly outside
    [0, 1] (z-scored or raw intensities), which the feed would crush."""
    img = arrays[Tags.img]
    if img.dtype == np.uint8:
        return arrays
    frac_outside = float(np.mean((img < -1e-6) | (img > 1.0 + 1e-6)))
    if frac_outside > 0.01:
        raise ValueError(
            f"feed_uint8=true but {frac_outside:.1%} of image values fall outside [0, 1] "
            "(z-scored/raw data?); disable feed_uint8 or normalize images to [0, 1] first")
    if frac_outside > 0:
        print(f"[trainer] feed_uint8: clipping {frac_outside:.2%} of image values to [0, 1]")
    return {**arrays, Tags.img: np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)}


def _to_device(batch: Dict[str, np.ndarray], device: torch.device,
               pin: bool = False) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on `device`; with `pin`, through pinned host
    memory and a copy that does not block the host."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if pin and device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=pin)
    return out


def _device_prefetch(batch_iter: Iterator, device: torch.device,
                     depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches on the device, made by a background thread: it gathers the
    next batch, pins it and starts its copy while the caller's step runs.
    At most `depth` batches wait. An error in the thread is raised here;
    closing the generator stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batch_iter:
                if not put(_to_device(b, device, pin=True)):
                    return
        except Exception as exc:  # handed to the consuming loop
            put(exc)
            return
        put(done)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=10.0)


def _iterate(arrays, batch_size, rng, shuffle=True, drop_last=True):
    """numpy batches in the JAX trainer's order (`data/camus.py
    iterate_batches`: one `rng.permutation` per shuffled epoch), string and
    object arrays left out; a split smaller than one batch is one batch."""
    arrays = {k: v for k, v in arrays.items()
              if isinstance(v, np.ndarray) and v.dtype != object and v.dtype.kind != "U"}
    return iterate_batches(arrays, batch_size, rng, shuffle,
                           drop_last and len(arrays[Tags.img]) >= batch_size)
