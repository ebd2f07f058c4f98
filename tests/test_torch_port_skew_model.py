"""PyTorch port vs JAX package: the skew model and task (models/unet.py
`bottleneck_out` and `ConfidenceNet`, tasks/dsnt_skew.py `SkewUNet` and
`DSNTSkew`, convert.py's SkewUNet tree), the SkewUNet's MC-dropout route
(tasks/dsnt_al.py `mc_dropout_apply`) and `freeze_seg` in the trainer.

The SkewUNet (a 4-stage UNet at 64^2 with drop_block, and the skew head
on skew_indices (0, 5, 10, 15, 20), so the alpha scatter is held too) is
initialised from a seed in the port; `torch_to_flax_params` (below, the
inverse of convert.flax_to_torch_state) puts its weights on the flax model's
parameter tree (its shapes from `jax.eval_shape`, no flax init), and
convert.flax_to_torch_state must give them back unchanged, so both sides
run the same weights.
"""

from collections.abc import Mapping

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
from contouring_uncertainty_tpu.tasks.dsnt_skew import DSNTSkew as JSkew
from contouring_uncertainty_torch.convert import flax_to_torch_state
from contouring_uncertainty_torch.data.config import DataParams
from contouring_uncertainty_torch.data.synthetic import make_arrays
from contouring_uncertainty_torch.models import unet as tunet
from contouring_uncertainty_torch.tasks import DSNTSkew, SkewUNet
from contouring_uncertainty_torch.tasks.dsnt_al import mc_dropout_apply
from contouring_uncertainty_torch.train import Trainer, TrainerConfig

torch.set_num_threads(1)

SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3, drop_block=True)
DP = dict(in_shape=(1, 64, 64), out_shape=(21, 2))
SKEW5 = (0, 5, 10, 15, 20)


def torch_to_flax_params(state, like):
    """The inverse of convert.flax_to_torch_state: the port's `state_dict` as a
    flax parameter tree shaped like `like` (a tree of arrays or of
    `jax.ShapeDtypeStruct`s, e.g. from `jax.eval_shape(model.init, ...)`),
    as nested dicts of f32 numpy arrays."""
    if "params" in like and len(like) == 1:
        like = like["params"]

    def walk(tree, path):
        out = {}
        for name, value in tree.items():
            if isinstance(value, Mapping):
                out[name] = walk(value, path + [name])
                continue
            prefix = ".".join(path)
            t = state[f"{prefix}.{'bias' if name == 'bias' else 'weight'}"].detach().cpu()
            if name == "kernel":
                if path[-1].startswith("ConvTranspose"):
                    t = t.permute(2, 3, 0, 1).flip(0).flip(1)
                elif path[-1].startswith("Dense"):
                    t = t.t()
                else:
                    t = t.permute(2, 3, 1, 0)
            elif name not in ("scale", "bias"):
                raise KeyError(f"unexpected flax parameter {prefix}.{name}")
            arr = t.to(torch.float32).contiguous().numpy()
            if tuple(arr.shape) != tuple(value.shape):
                raise ValueError(f"{prefix}.{name}: {arr.shape} against {tuple(value.shape)}")
            out[name] = arr
        return out

    return walk(like, [])


@pytest.fixture(scope="module")
def pair():
    """The JAX task and flax weights, the port's task and SkewUNet with the
    same weights, and a batch of four synthetic frames."""
    img, gt, contour = make_arrays(4, size=64, seed=3)
    batch = {"img": img, "gt": gt, "contour": contour}
    jtask = JSkew(data_params=JDataParams(**DP), t_e=1, model_kwargs=dict(SMALL),
                  skew_indices=SKEW5)
    jmodel = jtask.build_model()
    task = DSNTSkew(data_params=DataParams(**DP), t_e=1, model_kwargs=dict(SMALL),
                    skew_indices=SKEW5)
    model = task.build_model(device="cpu", generator=torch.Generator().manual_seed(4))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.asarray(img))
    params = torch_to_flax_params(model.state_dict(), shapes)
    back = flax_to_torch_state(params)
    assert set(back) == set(model.state_dict())
    for name, value in model.state_dict().items():
        assert torch.equal(back[name], value), name
    variables = {"params": jax.tree.map(jnp.asarray, params)}
    return jtask, jmodel, variables, params, task, model, batch


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_skew_unet_matches_flax(pair):
    """The SkewUNet's outputs through convert.py, the Dense kernel (in,
    out) -> (out, in) with the flatten in flax's NHWC order: the bottleneck
    (NHWC in flax, NCHW in the port) f32, alpha_raw (N, 5, 2) and the
    logits within 1e-4 of their scale (f32 convolutions reduce in another
    order: measured 4e-5). decode_from_prefix gives the same outputs."""
    jtask, jmodel, variables, params, task, model, batch = pair
    assert set(params) == {"unet", "confidence_net"}
    assert params["confidence_net"]["Dense_0"]["kernel"].shape == (128 * 8 * 8, 10)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(batch["img"]))
    with torch.no_grad():
        got = model(torch.as_tensor(batch["img"]))
        prefix = model(torch.as_tensor(batch["img"]), mode="encode_prefix")
        tail = model(None, mode="decode_from_prefix", prefix=prefix)
    assert set(prefix) == {"skips"}
    pairs = {"bottleneck": np.asarray(ref["bottleneck"]).transpose(0, 3, 1, 2),
             "alpha_raw": np.asarray(ref["alpha_raw"]), "out": np.asarray(ref["out"])}
    assert got["bottleneck"].dtype == got["alpha_raw"].dtype == torch.float32
    for key, r in pairs.items():
        assert got[key].shape == r.shape, key
        np.testing.assert_allclose(got[key].numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=key)
        torch.testing.assert_close(tail[key], got[key], rtol=0, atol=1e-5)


def test_confidence_net_runs_in_f32_under_a_bf16_backbone(pair):
    """With a bf16 backbone (the serving dtype) the bottleneck still comes
    out f32 and the ConfidenceNet computes in f32, as in JAX."""
    *_, params, task, _, batch = pair
    bf16 = DSNTSkew(data_params=DataParams(**DP), t_e=1, skew_indices=SKEW5,
                    model_kwargs={**SMALL, "dtype": "bfloat16", "head_dtype": "bfloat16"})
    model = bf16.build_model(device="cpu")
    model.load_state_dict(flax_to_torch_state(params))
    with torch.no_grad():
        out = model(torch.as_tensor(batch["img"]))
    assert out["out"].dtype == torch.bfloat16
    assert out["bottleneck"].dtype == out["alpha_raw"].dtype == torch.float32
    assert model.confidence_net.Dense_0.weight.dtype == torch.float32


def _generic_heatmap_logits(seed, n=2, k=21, size=32):
    """Logits of rotated anisotropic Gaussian blobs (1.5-7.5 px, centres
    off the pixel grid) around synthetic landmarks: generic heatmaps, as a
    trained head gives them."""
    rng = np.random.default_rng(seed)
    y = make_arrays(n, k=k, size=size, seed=seed)[2]
    yy, xx = np.mgrid[0:size, 0:size]
    th = rng.uniform(0, np.pi, (n, k, 1, 1))
    u = xx - y[..., 0, None, None] - rng.uniform(-0.5, 0.5, (n, k, 1, 1))
    v = yy - y[..., 1, None, None] - rng.uniform(-0.5, 0.5, (n, k, 1, 1))
    s1 = rng.uniform(1.5, 3.0, (n, k, 1, 1))
    s2 = s1 * rng.uniform(1.3, 2.5, (n, k, 1, 1))
    logits = -((np.cos(th) * u + np.sin(th) * v) ** 2 / (2 * s1 ** 2)
               + (-np.sin(th) * u + np.cos(th) * v) ** 2 / (2 * s2 ** 2))
    alpha = rng.normal(scale=2.0, size=(n, k, 2))
    return logits.astype(np.float32), alpha.astype(np.float32), y


def test_skew_head_gradient_matches_jax_and_f64():
    """d(mean skew NLL)/d(logits, alpha) through logits_to_pixel_gaussians
    (the moments' adjoint) and bsn.nll, on generic heatmaps: the port
    within 2e-5 of the same computation in f64 (measured 3.5e-6) and
    within 5e-4 of jax.grad of the JAX head (measured 1.0e-4; JAX's f32
    autodiff is the looser side: 1.0e-4 from f64), each relative to the
    largest gradient."""
    from contouring_uncertainty_tpu.distributions import bsn as jbsn
    from contouring_uncertainty_tpu.ops import dsnt as jd
    from contouring_uncertainty_torch.distributions import bsn
    from contouring_uncertainty_torch.ops import dsnt as td

    x, a, y = _generic_heatmap_logits(7)

    def jloss(xl, al):
        mu, sigma = jd.logits_to_pixel_gaussians(xl)
        return jbsn.nll(jnp.asarray(y), mu, sigma, al)[0].mean()

    def tgrad(dtype):
        xt = torch.tensor(x, dtype=dtype, requires_grad=True)
        at = torch.tensor(a, dtype=dtype, requires_grad=True)
        mu, sigma = td.logits_to_pixel_gaussians(xt)
        bsn.nll(torch.as_tensor(y, dtype=dtype), mu, sigma, at)[0].mean().backward()
        return xt.grad.numpy(), at.grad.numpy()

    ref = [np.asarray(g) for g in jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(a))]
    for got, f64, r in zip(tgrad(torch.float32), tgrad(torch.float64), ref):
        scale = np.abs(f64).max()
        np.testing.assert_allclose(got, f64, rtol=0, atol=2e-5 * scale)
        np.testing.assert_allclose(got, r, rtol=0, atol=5e-4 * scale)


def test_loss_logs_and_every_gradient_match_jax(pair):
    """DSNTSkew.loss (deterministic forward) against the JAX task's loss:
    the six logs (loss, distance_loss, loss_term1..3, alpha_norm) within
    1e-5 relative, and every parameter's gradient, the ConfidenceNet's and
    the backbone's through the skew NLL, against jax.grad, per leaf within
    5e-3 of the leaf's largest gradient plus 1e-5 of the largest gradient of
    all. Measured 3.2e-3, on the first stage's second convolution: the two
    frameworks' f32 convolution gradients differ as for DSNT-AL (held at
    1e-3 in tests/test_torch_port_train_task.py), and the skew NLL's
    derivative through Sigma^{-1/2} amplifies the difference; the head
    alone is held tighter above."""
    jtask, jmodel, variables, params, task, model, batch = pair

    def jloss(p):
        return jtask.loss(jmodel, {"params": p}, jax.tree.map(jnp.asarray, batch), None,
                          train=False)

    (_, jlogs), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    model.zero_grad(set_to_none=True)
    loss, logs = task.loss(model, _tbatch(batch), generator=None, train=False)
    loss.backward()
    assert set(logs) == set(jlogs) == {"loss", "distance_loss", "loss_term1", "loss_term2",
                                       "loss_term3", "alpha_norm"}
    for key in logs:
        np.testing.assert_allclose(float(logs[key].detach()), float(jlogs[key]), rtol=1e-5,
                                   err_msg=key)
    ref = flax_to_torch_state(jax.tree.map(np.asarray, jgrads))
    grads = dict(model.named_parameters())
    assert set(ref) == set(grads)
    floor = 1e-5 * max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        scale = float(np.abs(g.numpy()).max())
        np.testing.assert_allclose(grads[name].grad.numpy(), g.numpy(), rtol=0,
                                   atol=5e-3 * scale + floor, err_msg=name)
    model.zero_grad(set_to_none=True)


def test_predict_and_val_metrics_match_jax(pair):
    """predict at T_e=1: mu within 1e-4 px, cov within 1e-4 of its scale,
    alpha (scattered, zeros off the skew points, y flipped) within 1e-4 of
    its scale; the validation Dice of the linear reconstruction (through
    the crossing selection) equal, and the loss logs within 1e-5."""
    jtask, jmodel, variables, params, task, model, batch = pair
    img = batch["img"][:2]
    ref = [np.asarray(a) for a in jax.jit(
        lambda v, x: jtask.predict(jmodel, v, x, rng=jax.random.key(0)))(variables,
                                                                           jnp.asarray(img))]
    with torch.no_grad():
        got = [a.numpy() for a in task.predict(model, torch.as_tensor(img))]
    for name, g, r in zip(("mu", "cov", "alpha"), got, ref):
        assert g.shape == r.shape == (2, 1, 21) + r.shape[3:], name
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * max(np.abs(r).max(), 1.0),
                                   err_msg=name)
    off = np.setdiff1d(np.arange(21), SKEW5)
    assert (got[2][:, :, off] == 0).all() and (np.abs(got[2][:, :, list(SKEW5)]) > 0).all()

    jval = jax.jit(lambda v, b: jtask.val_metrics(jmodel, v, b))(
        variables, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        val = task.val_metrics(model, _tbatch(batch))
    assert set(val) == set(jval)
    assert float(val["dice"]) == float(jval["dice"])
    for key in val:
        np.testing.assert_allclose(float(val[key]), float(jval[key]), rtol=1e-5, err_msg=key)


def test_skew_unet_mc_dropout_takes_the_shared_prefix(pair, monkeypatch):
    """mc_dropout_apply routes a SkewUNet through its UNet's shared encoder
    prefix (encode_prefix once at batch N, decode_from_prefix on the T_e*N
    rows, in T_e = 3 row blocks of N) and matches the full forward of the
    tiled input with the same generator seed, logits and alpha_raw within
    1e-5; a model that neither is nor wraps a UNet (the other backbones)
    runs that tiled forward itself, as the JAX task's route for them."""
    *_, task, model, batch = pair
    modes = []
    forward = tunet.UNet.forward

    def recording(self, x, *args, mode="full", **kwargs):
        modes.append(mode)
        return forward(self, x, *args, mode=mode, **kwargs)

    monkeypatch.setattr(tunet.UNet, "forward", recording)
    x = torch.as_tensor(batch["img"][:2])
    with torch.no_grad():
        shared = mc_dropout_apply(model, x, 3, torch.Generator().manual_seed(5))
        assert modes == ["encode_prefix"] + ["decode_from_prefix"] * 3
        tiled = model(x.repeat(3, 1, 1, 1), deterministic=False,
                      generator=torch.Generator().manual_seed(5))
    for key in ("out", "alpha_raw"):
        torch.testing.assert_close(shared[key], tiled[key], rtol=0, atol=1e-5)
    assert float((shared["alpha_raw"][:2] - shared["alpha_raw"][2:4]).abs().max()) > 0

    class NotAUNet(torch.nn.Module):
        def forward(self, x, **kwargs):
            return model(x, **kwargs)

    modes.clear()
    with torch.no_grad():
        other = mc_dropout_apply(NotAUNet(), x, 3, torch.Generator().manual_seed(5))
    assert modes == ["full"] * 3
    for key in ("out", "alpha_raw"):
        torch.testing.assert_close(other[key], tiled[key], rtol=0, atol=0)
    with pytest.raises(ValueError, match="bottleneck_out"):
        SkewUNet(model.unet.__class__((1, 64, 64), (21, 64, 64), **SMALL), 5)


def test_freeze_seg_step_matches_optax_multi_transform(pair):
    """One AdamW step of the port's Trainer with task.freeze_seg: every
    `unet.*` tensor stays bitwise unchanged (no gradient, out of the
    optimizer: weight decay does not touch it) and every
    `confidence_net.*` tensor moves; both as optax.multi_transform with
    set_to_zero on the JAX task's "freeze" labels does on the same
    gradients: the moved tensors within 1e-6 (f32 rounding of one AdamW
    update of lr 1e-3 on weights of order 0.1-1)."""
    jtask, jmodel, variables, params, _, _, batch = pair
    frozen = JSkew(data_params=JDataParams(**DP), skew_indices=SKEW5, freeze_seg=True,
                   model_kwargs=dict(SMALL))
    task = DSNTSkew(data_params=DataParams(**DP), skew_indices=SKEW5, freeze_seg=True,
                    model_kwargs=dict(SMALL))
    trainer = Trainer(task, TrainerConfig(optimizer="adamw", lr=1e-3, weight_decay=1e-3,
                                          augment=False, seed=2), device="cpu")
    trainer.init_state()
    model = trainer.model
    model.load_state_dict(flax_to_torch_state(params))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer.train_step(_tbatch(batch), 0)
    after = model.state_dict()
    names = list(before)
    assert {n.split(".")[0] for n in names} == {"unet", "confidence_net"}
    for name in names:
        if name.startswith("unet."):
            assert torch.equal(after[name], before[name]), name
            assert model.get_parameter(name).grad is None, name
        else:
            assert not torch.equal(after[name], before[name]), name

    # optax on the same gradients: the port's for the head, ones for the
    # frozen backbone (set_to_zero ignores them).
    def flax_grad(path, leaf):
        keys = [p.key for p in path]
        if keys[0] == "unet":
            return jnp.ones(leaf.shape, jnp.float32)
        name = ".".join(keys[:-1] + ["weight" if keys[-1] == "kernel" else keys[-1]])
        g = model.get_parameter(name).grad.numpy()
        if keys[-1] == "kernel":
            g = g.T if keys[-2].startswith("Dense") else g.transpose(2, 3, 1, 0)
        return jnp.asarray(g)

    jgrads = jax.tree_util.tree_map_with_path(flax_grad, params)
    labels = frozen.optimizer_labels(params)
    assert set(jax.tree_util.tree_leaves(labels["unet"])) == {"freeze"}
    tx = optax.multi_transform({"train": optax.adamw(1e-3, weight_decay=1e-3),
                                "freeze": optax.set_to_zero()}, labels)
    new = flax_to_torch_state(jax.tree.map(np.asarray, jax.jit(
        lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(jgrads, params)))
    for name in names:
        np.testing.assert_allclose(after[name].numpy(), new[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)

