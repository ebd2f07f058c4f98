"""PyTorch port vs JAX package: the trainer's fit (train/trainer.py,
train/checkpoint.py, train/logging.py, utils/profiling.py).

One update of the JAX trainer (its jitted train and eval steps) against
the port's fit with fast_dev_run=1 on the same initial weights and data; then the port's fit alone: losses fall, files written,
resume, early stopping, divergence, the prefetch thread.
"""

import csv
import threading

import numpy as np
import pytest
import torch

import jax

from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
from contouring_uncertainty_tpu.parallel import make_mesh, shard_batch
from contouring_uncertainty_tpu.tasks import DSNTAleatoric as JTask
from contouring_uncertainty_tpu.train import Trainer as JTrainer
from contouring_uncertainty_tpu.train import TrainerConfig as JTrainerConfig
from contouring_uncertainty_torch.convert import flax_to_torch_state
from contouring_uncertainty_torch.data.synthetic import synthetic_camus_data
from contouring_uncertainty_torch.tasks import DSNTAleatoric
from contouring_uncertainty_torch.train import Trainer, TrainerConfig
from contouring_uncertainty_torch.train import trainer as trainer_mod
from contouring_uncertainty_torch.train.checkpoint import load_meta, restore_checkpoint

torch.set_num_threads(1)

SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3)


@pytest.fixture(scope="module")
def data():
    return synthetic_camus_data(n_patients=5, size=64, seed=1)


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_one_update_matches_the_jax_trainer(data, tmp_path, monkeypatch):
    """The JAX trainer's train_step and eval_step (SGD, lr 0.1, augmentation
    and dropout off, its seed-initialised weights, the first batch of its
    `_iterate` order) against the port's fit with fast_dev_run=1 (one train
    step, one validation batch) from the same weights: the same loss, the
    same validation loss after the update, and the CSV columns that the JAX
    fit writes from those logs (epoch, time, lr, then train/ and val/ keys
    in the jitted steps' order).

    The update is lr times the gradient. The port's is held to the same
    update in f64 (the port's model and batch in f64) within 2e-5 of each
    leaf's largest plus 1e-4 of the largest of all, and to JAX's within
    1e-2 plus that floor: JAX's f32 convolution gradients on the CPU sit up
    to 3.5e-3 of a leaf's largest from f64 on these inputs, and the conv
    biases ahead of an instance norm have an exact gradient of 0, so theirs
    is rounding noise (up to ~3e-5 of the largest gradient)."""
    train, val = data.train_arrays("train"), data.train_arrays("val")
    common = dict(batch_size=4, max_epochs=3, lr=0.1, optimizer="sgd", seed=3,
                  fast_dev_run=1, augment=False, name="one", save_every=0)
    jtask = JTask(data_params=JDataParams(in_shape=(1, 64, 64), out_shape=(21, 2)),
                  model_kwargs=dict(SMALL))
    jtrainer = JTrainer(jtask, JTrainerConfig(save_path=str(tmp_path / "jax"), **common),
                        mesh=make_mesh(1))
    state = jtrainer.init_state(jax.random.key(3))
    p0 = flax_to_torch_state(jax.tree.map(np.asarray, state.params))
    jtrainer._build_steps()
    rng = np.random.default_rng(3)
    first = next(trainer_mod._iterate(train, 4, rng))
    state, jlogs = jtrainer._train_step(state, shard_batch(first, jtrainer.mesh),
                                        jax.random.key(3), np.uint32(0))
    val_batch = next(trainer_mod._iterate(val, 4, rng, shuffle=False, drop_last=False))
    jval = jtrainer._eval_step(state, shard_batch(val_batch, jtrainer.mesh))
    jafter = flax_to_torch_state(jax.tree.map(np.asarray, state.params))
    header = (["epoch", "time", "lr"] + [f"train/{k}" for k in jlogs]
              + [f"val/{k}" for k in jval])

    original = Trainer.init_state

    def init_from_jax(self):
        original(self)
        self.model.load_state_dict(p0)

    monkeypatch.setattr(Trainer, "init_state", init_from_jax)
    task = DSNTAleatoric(data_params=data.data_params, model_kwargs=dict(SMALL))
    trainer = Trainer(task, TrainerConfig(save_path=str(tmp_path / "torch"), **common),
                      device="cpu")
    after, ckpt = trainer.fit(train, val)

    (row,) = trainer.history
    assert list(row) == header
    assert _csv(tmp_path / "torch" / "3" / "one_metrics.csv")[0] == header
    assert row["lr"] == float(jtrainer._lr_schedule()(1))
    for key, value in jlogs.items():
        np.testing.assert_allclose(row[f"train/{key}"], float(value), rtol=1e-5, err_msg=key)
    for key, value in jval.items():
        if key != "dice":
            np.testing.assert_allclose(row[f"val/{key}"], float(value), rtol=1e-4, err_msg=key)
    assert abs(row["val/dice"] - float(jval["dice"])) < 1e-3

    model64 = task.build_model(device="cpu").double()
    model64.load_state_dict(p0)
    batch64 = {k: torch.as_tensor(v).double() if v.dtype.kind == "f" else torch.as_tensor(v)
               for k, v in first.items()}
    task.loss(model64, batch64, train=True)[0].backward()
    # SGD with the default weight decay 1e-3 added to the gradient.
    update64 = {n: -0.1 * (p.grad + 1e-3 * p.detach()) for n, p in model64.named_parameters()}
    floor = 1e-4 * max(float(u.abs().max()) for u in update64.values())
    for name, u64 in update64.items():
        got, ref = (after[name] - p0[name]).double(), (jafter[name] - p0[name]).double()
        scale = float(u64.abs().max())
        np.testing.assert_allclose(got.numpy(), u64.numpy(), rtol=0,
                                   atol=2e-5 * scale + floor, err_msg=name)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-2 * scale + floor,
                                   err_msg=name)
    assert max(float(u.abs().max()) for u in update64.values()) > 1e-3
    saved = restore_checkpoint(ckpt)["params"]
    assert all(torch.equal(saved[k], after[k]) for k in after)


def test_fit_trains_writes_and_resumes(data, tmp_path):
    """A short fit (AdamW, augmentation and drop_block on, batches fed by
    the prefetch thread): the training loss falls, the CSV, JSONL, phases,
    summary and checkpoints are written, the resumable checkpoint holds
    epoch 3, and a fit resumed from it runs epochs 4 and 5 only, from the
    saved weights and update count."""
    train, val = data.train_arrays("train"), data.train_arrays("val")
    task = DSNTAleatoric(data_params=data.data_params, model_kwargs=dict(SMALL, drop_block=True))
    cfg = TrainerConfig(batch_size=4, max_epochs=4, seed=2, save_path=str(tmp_path),
                        name="resume", save_every=2)
    trainer = Trainer(task, cfg, device="cpu")
    trainer.fit(train, val)
    losses = [row["train/loss"] for row in trainer.history]
    assert [row["epoch"] for row in trainer.history] == [0, 1, 2, 3]
    assert losses[-1] < losses[0]
    run_dir = tmp_path / "2"
    for name in ("resume_metrics.csv", "resume_metrics.jsonl", "resume_phases.json",
                 "summary.txt", "train_complete", "resume.ckpt/state.pt",
                 "resume.ckpt/meta.json", "resume_last.ckpt/state.pt"):
        assert (run_dir / name).exists(), name
    assert len(_csv(run_dir / "resume_metrics.csv")) == 5
    last = run_dir / "resume_last.ckpt"
    assert load_meta(last)["epoch"] == 3
    steps_per_epoch = len(train["img"]) // 4
    assert restore_checkpoint(last)["step"] == 4 * steps_per_epoch

    cfg2 = TrainerConfig(batch_size=4, max_epochs=6, seed=2, save_path=str(tmp_path),
                         name="resume2", save_every=0)
    trainer2 = Trainer(task, cfg2, device="cpu")
    trainer2.fit(train, val, resume_from=str(last))
    assert [row["epoch"] for row in trainer2.history] == [4, 5]
    assert "total parameters: " in (run_dir / "summary.txt").read_text()


@pytest.mark.parametrize("case", ["early_stop", "diverged"])
def test_fit_stops_early_and_on_divergence(data, tmp_path, monkeypatch, case):
    """With the steps replaced by fixed logs: a validation loss that never
    improves stops the fit after `patience` epochs (not before
    `min_epochs`), keeping epoch 0's weights as the best; an epoch whose
    train losses are all non-finite aborts the fit with a `diverged` row."""
    val_losses = iter([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0])
    train_loss = float("nan") if case == "diverged" else 1.0

    def train_step(self, batch, step):
        with torch.no_grad():
            next(self.model.parameters()).add_(1.0)
        return {"loss": torch.tensor(train_loss)}

    def eval_step(self, batch):
        return {"loss": torch.tensor(next(val_losses))}

    monkeypatch.setattr(Trainer, "train_step", train_step)
    monkeypatch.setattr(Trainer, "eval_step", eval_step)
    task = DSNTAleatoric(data_params=data.data_params, model_kwargs=dict(SMALL))
    cfg = TrainerConfig(batch_size=8, max_epochs=8, patience=1, min_epochs=3, seed=0,
                        save_path=str(tmp_path), name="stop", save_every=0)
    trainer = Trainer(task, cfg, device="cpu")
    best, _ = trainer.fit(data.train_arrays("train"), data.train_arrays("val"))
    if case == "diverged":
        assert trainer.history == [{"epoch": 0, "diverged": 1.0}]
        return
    assert [row["epoch"] for row in trainer.history] == [0, 1, 2]
    steps = len(data.train_arrays("train")["img"]) // 8
    first = next(iter(best.values()))
    assert torch.allclose(first, next(trainer.model.parameters()) - 2 * steps)


def test_device_prefetch_stops_its_thread_and_raises_its_errors():
    """Closing the prefetch generator early stops its thread; an error
    while making a batch is raised in the consuming loop."""
    def batches(fail_at=None):
        for i in range(100):
            if i == fail_at:
                raise ValueError("bad batch")
            yield {"img": np.full((2, 1, 4, 4), i, np.float32)}

    before = set(threading.enumerate())
    gen = trainer_mod._device_prefetch(batches(), torch.device("cpu"))
    assert float(next(gen)["img"][0, 0, 0, 0]) == 0.0
    gen.close()
    for t in set(threading.enumerate()) - before:
        t.join(timeout=10.0)
        assert not t.is_alive()
    with pytest.raises(ValueError, match="bad batch"):
        list(trainer_mod._device_prefetch(batches(fail_at=3), torch.device("cpu")))
