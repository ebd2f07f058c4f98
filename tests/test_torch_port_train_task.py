"""PyTorch port vs JAX package: the DSNT-AL task's training loss and
validation metrics, the UNet in training mode, the training augmentation
and the Dice metric (tasks/dsnt_al.py, models/unet.py, data/augment.py,
utils/metrics.py).

Both sides get the same numpy inputs; the flax weights reach the port
through convert.flax_to_torch_state, and so do the flax gradients (a
gradient tree has the parameter tree's structure).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu.data import augment as jaug
from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
from contouring_uncertainty_tpu.tasks import DSNTAleatoric as JTask
from contouring_uncertainty_tpu.utils.metrics import dice_binary as jdice
from contouring_uncertainty_torch.convert import flax_to_torch_state
from contouring_uncertainty_torch.data import augment as taug
from contouring_uncertainty_torch.data.config import DataParams
from contouring_uncertainty_torch.data.synthetic import make_arrays
from contouring_uncertainty_torch.models.layers import set_compute_dtype
from contouring_uncertainty_torch.models.unet import leaky_relu_sides
from contouring_uncertainty_torch.tasks import DSNTAleatoric
from contouring_uncertainty_torch.utils.metrics import dice_binary

torch.set_num_threads(1)

SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3)
DP = dict(in_shape=(1, 64, 64), out_shape=(21, 2))
WEIGHTS = dict(mse_weight=0.7, log_penalty_weight=1.3)


@pytest.fixture(scope="module")
def pair():
    """The JAX task and flax weights, the port's task and model with the
    same weights, and a batch of synthetic frames."""
    img, gt, contour = make_arrays(4, size=64, seed=3)
    batch = {"img": img, "gt": gt, "contour": contour}
    jtask = JTask(data_params=JDataParams(**DP), model_kwargs=dict(SMALL), **WEIGHTS)
    jmodel = jtask.build_model()
    variables = jax.jit(jmodel.init)(jax.random.key(4), jnp.asarray(img))
    task = DSNTAleatoric(data_params=DataParams(**DP), model_kwargs=dict(SMALL), **WEIGHTS)
    model = task.build_model(device="cpu")
    model.load_state_dict(flax_to_torch_state(jax.tree.map(np.asarray, variables["params"])))
    return jtask, jmodel, variables, task, model, batch


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_loss_logs_and_every_gradient_match_jax(pair):
    """task.loss(train=True) (drop_block off, so the forward is
    deterministic) against the JAX task's loss: the four logs within 1e-5
    relative, and every parameter's gradient against jax.grad, per leaf,
    within 1e-3 of the leaf's largest gradient plus 1e-5 of the largest
    gradient of all (the conv biases before an instance norm have an exact
    gradient of 0, so theirs is rounding noise on both sides).

    Both f32 gradients are also held to a true f64 model's
    (`set_compute_dtype`). An f32 forward puts an activation within
    rounding of zero on the other side of a LeakyReLU kink now and then,
    and every gradient behind it moves by ~1e-3 of a leaf (here the port's
    forward flips 3 of 3.8M activations and JAX's 2, other ones: 1.29e-3
    and 4.95e-4 of a leaf from the f64 gradients). So each side's flips
    are counted against the f64 forward's sides (at most 8, each within
    1e-5 of zero there), and each side is held to the f64 model pinned to
    its own forward's sides (`leaky_relu_sides`): the port per leaf within
    2e-5 of the leaf's largest value plus the floor (measured 5.6e-6 of a
    leaf), and its worst leaf no farther than JAX's (measured 1.9e-5)."""
    jtask, jmodel, variables, task, model, batch = pair

    def jloss(params):
        capture = _NormCapture(jmodel)
        loss, logs = jtask.loss(capture, {"params": params}, jax.tree.map(jnp.asarray, batch),
                                jax.random.key(0), train=True)
        return loss, (logs, capture.norms)

    (_, (jlogs, jnorms)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    model.zero_grad(set_to_none=True)
    with leaky_relu_sides(model) as port_sides:
        loss, logs = task.loss(model, _tbatch(batch), generator=torch.Generator().manual_seed(0),
                               train=True)
        loss.backward()
    assert set(logs) == set(jlogs) == {"loss", "distance_loss", "loss_term1", "loss_term2"}
    for key in logs:
        np.testing.assert_allclose(float(logs[key].detach()), float(jlogs[key]), rtol=1e-5,
                                   err_msg=key)
    ref = flax_to_torch_state(jax.tree.map(np.asarray, jgrads))
    grads = dict(model.named_parameters())
    assert set(ref) == set(grads)
    floor = 1e-5 * max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        got = grads[name].grad.numpy()
        scale = float(np.abs(g.numpy()).max())
        np.testing.assert_allclose(got, g.numpy(), rtol=0, atol=1e-3 * scale + floor,
                                   err_msg=name)

    b64 = {k: v.double() if v.is_floating_point() else v for k, v in _tbatch(batch).items()}

    def f64_grads(pin=None):
        model64 = set_compute_dtype(task.build_model(device="cpu").double(), torch.float64)
        model64.load_state_dict(model.state_dict())
        pre = {}
        for name, mod in model64.named_modules():
            if name.endswith(".InstanceNorm_0"):
                layer = name[:-len(".InstanceNorm_0")]
                mod.register_forward_hook(
                    lambda m, i, y, layer=layer: pre.update({layer: y.detach()}))
        with leaky_relu_sides(model64, pin) as sides:
            task.loss(model64, b64, generator=None, train=True)[0].backward()
        return {n: p.grad.numpy() for n, p in model64.named_parameters()}, sides, pre

    _, sides64, pre64 = f64_grads()
    jax_sides = {name: torch.as_tensor(np.asarray(y).transpose(0, 3, 1, 2) > 0)
                 for name, y in jnorms.items()}
    worst = {}
    for label, sides, got in (
            ("port", port_sides, {n: p.grad.numpy() for n, p in grads.items()}),
            ("jax", jax_sides, {n: g.numpy() for n, g in ref.items()})):
        assert set(sides) == set(sides64), label
        flipped = {n: sides[n] != sides64[n] for n in sides64}
        assert sum(int(f.sum()) for f in flipped.values()) <= 8, label
        assert all(float(pre64[n][f].abs().max()) < 1e-5 for n, f in flipped.items() if f.any())
        g64 = f64_grads(sides)[0]
        leaves = [n for n in g64 if not n.endswith("Conv_0.bias")]
        worst[label] = max(np.abs(got[n] - g64[n]).max() / np.abs(g64[n]).max() for n in leaves)
        if label == "port":
            for n in g64:
                np.testing.assert_allclose(got[n], g64[n], rtol=0,
                                           atol=2e-5 * np.abs(g64[n]).max() + floor, err_msg=n)
    assert 0.0 < worst["port"] <= worst["jax"], worst


class _NormCapture:
    """Stands in for the flax model in the JAX task's loss: applies it with
    its InstanceNorm outputs (the LeakyReLU inputs) captured, keyed by the
    enclosing ConvLayer's path as the port names it."""

    def __init__(self, model):
        self.model, self.norms = model, {}

    def apply(self, variables, img, **kwargs):
        out, state = self.model.apply(
            variables, img, mutable=["intermediates"], **kwargs,
            capture_intermediates=lambda mdl, _: type(mdl).__name__ == "InstanceNorm")
        for path, y in jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]:
            keys = [p.key for p in path if getattr(p, "key", "__call__") != "__call__"]
            self.norms[".".join(keys[:-1])] = y
        return out


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


@pytest.mark.parametrize("kind", ["unet", "skew"])
def test_f64_model_computes_in_f64_throughout(kind):
    """Fault F4: `set_compute_dtype(model.double(), torch.float64)` gives a
    model that computes in f64 everywhere. Forward hooks on every module of
    a drop_block UNet (and of a SkewUNet, its ConfidenceNet and Dense layer
    included) see only f64 outputs, in the deterministic forward and in the
    MC-dropout forward with the encoder prefix shared; the logits, the
    bottleneck and alpha are f64, and so are the task's Gaussians."""
    from contouring_uncertainty_torch.tasks import DSNTSkew
    from contouring_uncertainty_torch.tasks.dsnt_al import mc_dropout_apply

    cls = DSNTSkew if kind == "skew" else DSNTAleatoric
    task = cls(data_params=DataParams(**DP), t_e=2, model_kwargs=dict(SMALL, drop_block=True))
    model = set_compute_dtype(task.build_model(device="cpu").double(), torch.float64)
    seen = []
    for name, mod in model.named_modules():
        mod.register_forward_hook(
            lambda m, i, out, name=name: seen.extend((name, t.dtype) for t in _tensors(out)))
    img = torch.as_tensor(make_arrays(2, size=64, seed=1)[0]).double()
    with torch.no_grad():
        outs = [model(img), mc_dropout_apply(model, img, 2, torch.Generator().manual_seed(0))]
        gaussians = task.predict(model, img, torch.Generator().manual_seed(0))
    assert len(seen) > 50
    assert [s for s in seen if s[1] != torch.float64] == []
    assert all(t.dtype == torch.float64 for out in outs for t in _tensors(out))
    assert all(t.dtype == torch.float64 for t in gaussians)
    assert {"out", "bottleneck", "alpha_raw"} <= set(outs[0]) if kind == "skew" else True
    # The instance norms' statistics are f64 too (f32 statistics of these
    # inputs, offset by 3 from zero, would be ~1e-6 off).
    norm = model.get_submodule(("unet." if kind == "skew" else "")
                               + "ConvBlock_0.ConvLayer_0.InstanceNorm_0")
    x = 3.0 + torch.as_tensor(np.random.default_rng(2).normal(size=(2, 32, 16, 16)))
    ref = (x - x.mean((2, 3), keepdim=True)) / torch.sqrt(x.var((2, 3), unbiased=False,
                                                                keepdim=True) + 1e-5)
    assert float((norm(x) - ref).abs().max()) < 1e-12


def test_val_metrics_match_jax(pair):
    """val_metrics: the loss logs within 1e-5 relative and the Dice of the
    linear reconstruction within 1e-3 (mu agrees to ~1e-4 px, so a boundary
    pixel may flip)."""
    jtask, jmodel, variables, task, model, batch = pair
    jlogs = jax.jit(lambda v, b: jtask.val_metrics(jmodel, v, b))(
        variables, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        logs = task.val_metrics(model, _tbatch(batch))
    assert set(logs) == set(jlogs)
    for key in ("loss", "distance_loss", "loss_term1", "loss_term2"):
        np.testing.assert_allclose(float(logs[key]), float(jlogs[key]), rtol=1e-5, err_msg=key)
    assert 0.0 < float(logs["dice"]) < 1.0
    assert abs(float(logs["dice"]) - float(jlogs["dice"])) < 1e-3


def test_training_mode_changes_only_the_dropout(pair):
    """The port's UNet has no module whose output depends on train()/eval():
    without dropout the two modes give the same logits, so build_model's
    .eval() does not interfere with training. With drop_block, train=True
    draws its channel masks from the step's generator: the same seed gives
    the same loss, another seed another loss, and train=False none."""
    _, _, _, task, model, batch = pair
    img = torch.as_tensor(batch["img"])
    with torch.no_grad():
        model.eval()
        a = model(img)["out"]
        model.train()
        b = model(img)["out"]
        model.eval()
    torch.testing.assert_close(a, b, rtol=0, atol=0)

    drop = DSNTAleatoric(data_params=DataParams(**DP), model_kwargs=dict(SMALL, drop_block=True))
    dmodel = drop.build_model(device="cpu", generator=torch.Generator().manual_seed(1))
    tb = _tbatch(batch)
    with torch.no_grad():
        losses = [float(drop.loss(dmodel, tb, torch.Generator().manual_seed(s), train=True)[0])
                  for s in (7, 7, 8)]
        det = [float(drop.loss(dmodel, tb, torch.Generator().manual_seed(s), train=False)[0])
               for s in (7, 8)]
    assert losses[0] == losses[1] != losses[2]
    assert det[0] == det[1] != losses[0]


def test_channel_dropout_keep_rate_matches_flax():
    """Dropout draws differ from JAX's by construction; in distribution they
    agree: channels kept with probability 0.5 (flax Dropout(0.5) broadcast
    over H, W) and scaled by 2, over 20,000 channels (4 sigma ~ 0.014)."""
    from flax import linen as nn

    from contouring_uncertainty_torch.models.layers import channel_dropout

    x = np.ones((200, 100, 2, 2), np.float32)
    jy = nn.Dropout(0.5, broadcast_dims=(1, 2)).apply(
        {}, jnp.asarray(x.transpose(0, 2, 3, 1)), deterministic=False,
        rngs={"dropout": jax.random.key(0)})
    ty = channel_dropout(torch.as_tensor(x), 0.5, torch.Generator().manual_seed(0))
    j_kept = float(np.mean(np.asarray(jy)[:, 0, 0, :] > 0))
    t_kept = float((ty[:, :, 0, 0] > 0).float().mean())
    assert abs(j_kept - 0.5) < 0.014 and abs(t_kept - 0.5) < 0.014
    assert set(np.unique(ty.numpy())) == {0.0, 2.0}


def _aug_inputs(n=6, size=48, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (n, 1, size, size)).astype(np.float32)
    gt = rng.integers(0, 3, (n, size, size)).astype(np.uint8)
    contour = rng.uniform(0, size, (n, 21, 2)).astype(np.float32)
    return {"img": img, "gt": gt, "contour": contour, "other": np.arange(n)}


# Angles and shifts: half-pixel nearest lookups (0.5 px shifts at angle 0:
# source coordinates land on k + 0.5, where rounding half away from zero
# and half to even disagree), shifts past the border, the default ranges.
AUG_CASES = {
    "half_pixel": ([0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                   [[0.5, 0.0], [0.0, -0.5], [1.5, 2.5], [-0.5, 0.5], [2.5, -3.5], [-7.5, 0.0]]),
    "rotated": ([2.5, -3.0, 1.0, -0.7, 90.0, 45.0],
                [[0.5, 0.5], [-4.2, 1.3], [0.0, 0.0], [3.0, -5.0], [0.0, 0.0], [0.25, -0.75]]),
    "far": ([0.0, 180.0, -30.0, 10.0, 0.0, 3.0],
            [[60.0, 0.0], [0.0, 0.0], [-20.0, 20.0], [0.0, -47.5], [47.5, 47.5], [5.0, 5.0]]),
}


@pytest.mark.parametrize("case", list(AUG_CASES))
def test_augment_apply_matches_jax(case):
    """augment.apply against the JAX apply on the same AugmentParams:
    warped masks exactly equal (nearest lookups rounded half away from
    zero, out-of-range neighbours zeroed), images within 1e-5 and keypoints
    within 1e-4 px (f32 cos/sin and pow of the two libraries), other keys
    passed through."""
    batch = _aug_inputs()
    angle, shift = (np.asarray(a, np.float32) for a in AUG_CASES[case])
    rng = np.random.default_rng(1)
    inten = [rng.uniform(-0.2, 0.2, 6).astype(np.float32), rng.uniform(-0.2, 0.2, 6).astype(np.float32),
             rng.uniform(0.8, 1.2, 6).astype(np.float32)]
    jp = jaug.AugmentParams(jnp.asarray(angle), jnp.asarray(shift), *map(jnp.asarray, inten))
    tp = taug.AugmentParams(torch.as_tensor(angle), torch.as_tensor(shift),
                            *map(torch.as_tensor, inten))
    jout = jaug.apply({k: jnp.asarray(v) for k, v in batch.items()}, jp)
    tout = taug.apply({k: torch.as_tensor(v) for k, v in batch.items()}, tp)
    assert tout["gt"].dtype == torch.uint8
    np.testing.assert_array_equal(tout["gt"].numpy(), np.asarray(jout["gt"]))
    np.testing.assert_allclose(tout["img"].numpy(), np.asarray(jout["img"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tout["contour"].numpy(), np.asarray(jout["contour"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tout["other"].numpy(), batch["other"])
    if case == "half_pixel":
        # The cases really sit on half pixels: torch.round would differ.
        half = torch.as_tensor(np.arange(48, dtype=np.float32) - 0.5)
        assert (taug._round_half_away(half) != torch.round(half)).any()


def test_augment_sampling_and_identity():
    """sample_params draws every parameter from its configured range with
    the range's mean (4000 draws, as JAX's sample_params does), and the
    identity parameters leave a [1e-8, 1] image, its mask and keypoints as
    they are."""
    n = 4000
    tp = taug.sample_params(torch.Generator().manual_seed(0), n)
    jp = jaug.sample_params(jax.random.key(0), n)
    cfg = taug.AugmentConfig()
    assert cfg == tuple(jaug.AugmentConfig())
    for name, lo, hi in (("angle_deg", -3, 3), ("brightness", -0.2, 0.2),
                         ("contrast", -0.2, 0.2), ("gamma", 0.8, 1.2)):
        t = getattr(tp, name).numpy()
        j = np.asarray(getattr(jp, name))
        assert t.shape == j.shape == (n,)
        assert lo <= t.min() and t.max() <= hi
        tol = 4 * (hi - lo) / np.sqrt(12 * n)
        assert abs(t.mean() - (lo + hi) / 2) < tol and abs(j.mean() - (lo + hi) / 2) < tol
    assert tp.shift.shape == (n, 2) and float(tp.shift.abs().max()) <= 5.0

    batch = _aug_inputs(n=3)
    batch["img"] = np.clip(batch["img"], 1e-8, 1.0)
    out = taug.apply({k: torch.as_tensor(v) for k, v in batch.items()}, taug.identity_params(3))
    np.testing.assert_array_equal(out["gt"].numpy(), batch["gt"])
    np.testing.assert_allclose(out["img"].numpy(), batch["img"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(out["contour"].numpy(), batch["contour"], rtol=0, atol=1e-5)


def test_dice_binary_matches_jax():
    """dice_binary over trailing (H, W), broadcast over leading axes,
    including empty masks (eps keeps 0/0 at 1)."""
    rng = np.random.default_rng(5)
    pred = rng.uniform(size=(2, 3, 16, 16)) > 0.5
    target = rng.uniform(size=(2, 3, 16, 16)) > 0.4
    pred[0, 0] = target[0, 0] = False
    got = dice_binary(torch.as_tensor(pred), torch.as_tensor(target)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdice(jnp.asarray(pred), jnp.asarray(target))),
                               rtol=1e-6)
    assert got[0, 0] == 1.0
