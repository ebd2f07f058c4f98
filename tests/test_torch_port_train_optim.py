"""PyTorch port vs JAX package: the trainer's optimizers and learning-rate
schedules (train/trainer.py `_make_optimizer`, `_lr_schedule`,
`apply_update`) against the optax transformations the JAX trainer builds
(`Trainer._make_optimizer`, `Trainer._lr_schedule`), on given gradient
trees.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from contouring_uncertainty_tpu.train.trainer import Trainer as JTrainer
from contouring_uncertainty_tpu.train.trainer import TrainerConfig as JTrainerConfig
from contouring_uncertainty_torch.train import Trainer, TrainerConfig

torch.set_num_threads(1)

OPTIMIZERS = {
    "adamw": dict(optimizer="adamw"),
    "adam": dict(optimizer="adam"),
    "sgd": dict(optimizer="sgd", momentum=0.0),
    "sgd_momentum": dict(optimizer="sgd", momentum=0.9),
    "rmsprop": dict(optimizer="rmsprop", momentum=0.0, rmsprop_alpha=0.9),
    "rmsprop_momentum": dict(optimizer="rmsprop", momentum=0.9, rmsprop_alpha=0.8),
}
# Horizons short enough that each schedule moves within the steps run.
SCHEDULES = {
    "constant": dict(lr_schedule=None),
    "cosine": dict(lr_schedule="cosine", lr_decay_steps=4),
    "exponential": dict(lr_schedule="exponential", lr_decay_steps=3, lr_decay_rate=0.5),
    "step": dict(lr_schedule="step", lr_decay_steps=2, lr_decay_rate=0.5),
}


def _configs(**kwargs):
    # lr 0.01: optax computes Adam's bias corrections in f32 (1 - f32(0.999)
    # is 1.3e-5 off 1e-3), which moves each Adam update by ~6e-6 of itself;
    # at this rate that stays under 1e-7 a step, while a wrong rule (eps
    # placement, momentum before or after the rate) moves the parameters by
    # ~1e-3.
    common = dict(lr=0.01, weight_decay=0.01, max_epochs=7)
    common.update(kwargs)
    return JTrainerConfig(**common), TrainerConfig(**common)


def _jax_trainer(cfg):
    """The JAX trainer's optimizer factory needs only its config."""
    trainer = object.__new__(JTrainer)
    trainer.config = cfg
    return trainer


def _trees(seed, steps=3):
    """Initial parameters and per-step gradients. The leaf "tiny" carries
    gradients of ~1e-4, where RMSprop's eps inside or outside the root and
    Adam's eps placement change the update visibly."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 3), "b": (5,), "tiny": (6,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (1e-4 if k == "tiny" else 1.0)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("warmup", [0, 2], ids=["no_warmup", "warmup"])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("optimizer", list(OPTIMIZERS))
def test_optimizer_steps_match_optax(optimizer, schedule, warmup):
    """3 updates on the same gradient trees: the port's optimizer (set up
    and stepped as the trainer does) against the optax chain the JAX
    trainer builds, parameters within 1e-6 (f32 rounding of a few
    operations on values of order 1)."""
    jcfg, tcfg = _configs(**OPTIMIZERS[optimizer], **SCHEDULES[schedule],
                          lr_warmup_steps=warmup)
    params, grads = _trees(seed=len(optimizer) + 10 * len(schedule) + warmup)

    tx = _jax_trainer(jcfg)._make_optimizer()
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    trainer = Trainer(None, tcfg, device="cpu")
    tparams = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    trainer.optimizer = trainer._make_optimizer(list(tparams.values()))
    for step, g in enumerate(grads):
        for k, p in tparams.items():
            p.grad = torch.as_tensor(g[k])
        trainer.apply_update(step)
    for k in params:
        moved = float(np.abs(np.asarray(jparams[k]) - params[k]).max())
        assert moved > 1e-4
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("warmup", [0, 5], ids=["no_warmup", "warmup"])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_schedule_values_match_optax(schedule, warmup):
    """The learning rate at a list of update counts against the optax
    schedule of the JAX trainer: within 1e-6 relative, or 1e-7 of the peak
    rate (optax evaluates in f32, and 1 + cos(pi t/T) cancels near the end
    of the cosine horizon). The default horizon is max_epochs * 100."""
    sched = dict(SCHEDULES[schedule], lr_decay_steps=0)
    jcfg, tcfg = _configs(**sched, lr_warmup_steps=warmup)
    jsched = _jax_trainer(jcfg)._lr_schedule()
    tsched = Trainer(None, tcfg, device="cpu")._lr_schedule()
    for count in (0, 1, 2, 4, 5, 6, 99, 100, 101, 350, 699, 700, 701, 2000):
        np.testing.assert_allclose(tsched(count), float(jsched(count)), rtol=1e-6,
                                   atol=1e-7 * tcfg.lr, err_msg=f"count {count}")
