"""PyTorch port vs JAX package: the segmentation baselines' building blocks
(tasks/segmentation.py losses, SSN distribution and draws; the UNet's SSN,
deep-supervision and bias heads and their conversion; ops/morphology.py;
utils/metrics.py; data/augment.py `un_apply_*`).

Models are 4-stage UNets at 64^2 (6 stages for the deep-supervision
ladder, which needs two heads), initialised from a seed in the port and put
on the flax tree by `torch_to_flax_params` (tests/test_torch_port_skew_model.py);
convert.flax_to_torch_state must give them back unchanged. The losses are
held with the same draws on both sides: the port's normals are replaced by
the JAX task's own draws from the keys it splits (the aleatoric eps; SSN's
eps_f and eps_d), and `drop_block` is off, so the forwards are
deterministic.

Tolerances: losses and logs within 1e-5 relative; gradients per leaf
within 1e-2 of the leaf's largest value plus 1e-5 of the largest gradient
of all (the conv biases ahead of an instance norm have a gradient of 0,
so theirs is rounding noise). Both packages' f32 gradients are farther
from the gradient of the same model in f64 than from each other: on the
SSN loss (a logsumexp over per-image sums of 4096 log-likelihoods) each
sits 3.8e-2 of a leaf from f64 and 8.0e-3 from the other; on the
deep-supervision ladder 3.9e-3 and 3.0e-3 from f64, 3.9e-3 apart (a CPU
run, `set_compute_dtype(model.double(), torch.float64)` with the same
draws). Heads and SSN
parameters within 1e-4 of their scale (f32 convolutions reduce in another
order); SSN draws and the augmentation inverses within 1e-5; morphology
bitwise.
"""

from functools import partial

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu.data import augment as jaug
from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
from contouring_uncertainty_tpu.data.config import Label as JLabel
from contouring_uncertainty_tpu.ops import morphology as jmorph
from contouring_uncertainty_tpu.tasks import segmentation as jseg
from contouring_uncertainty_tpu.utils import metrics as jmetrics
from contouring_uncertainty_torch.convert import flax_to_torch_state
from contouring_uncertainty_torch.data import augment as taug
from contouring_uncertainty_torch.data.config import DataParams, Label
from contouring_uncertainty_torch.data.synthetic import make_arrays
from contouring_uncertainty_torch.ops import morphology as tmorph
from contouring_uncertainty_torch.tasks import segmentation as tseg
from contouring_uncertainty_torch.utils import metrics as tmetrics
from test_torch_port_skew_model import torch_to_flax_params

torch.set_num_threads(1)

SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3)
DEEP = dict(kernels=((3, 3),) * 6, strides=((1, 1),) + ((2, 2),) * 5,
            deep_supervision=True, out_seg_bias=True)
LABELS = {1: ("BG", "LV"), 3: ("BG", "LV", "MYO")}


def _dp(channels, jax_side=False):
    enum = JLabel if jax_side else Label
    labels = tuple(enum[name] for name in LABELS[channels])
    cls = JDataParams if jax_side else DataParams
    return cls(in_shape=(1, 64, 64), out_shape=(channels, 64, 64), labels=labels)


def _batch(channels, n=4, seed=3):
    img, gt, _ = make_arrays(n, size=64, seed=seed)
    gt = gt.astype(np.int32)
    if channels == 3:  # a myocardium ring around the LV
        ring = ndimage.binary_dilation(gt > 0, iterations=3, axes=(1, 2)) & (gt == 0)
        gt = np.where(ring, 2, gt).astype(np.int32)
    return {"img": img, "gt": gt}


def make_pair(jcls, tcls, channels, model_kwargs, seed=4, **task_kwargs):
    """(JAX task, flax model, variables, port task, port model) with the
    same weights; the flax tree holds the training-only heads too."""
    jtask = jcls(data_params=_dp(channels, True), model_kwargs=dict(model_kwargs), **task_kwargs)
    task = tcls(data_params=_dp(channels), model_kwargs=dict(model_kwargs), **task_kwargs)
    jmodel = jtask.build_model()
    model = task.build_model(device="cpu", generator=torch.Generator().manual_seed(seed))
    img = jnp.zeros((2, 1, 64, 64), jnp.float32)
    shapes = jax.eval_shape(partial(jmodel.init, train=True), jax.random.key(0), img)
    params = torch_to_flax_params(model.state_dict(), shapes)
    back = flax_to_torch_state(params)
    assert set(back) == set(model.state_dict())
    for name, value in model.state_dict().items():
        assert torch.equal(back[name], value), name
    return jtask, jmodel, {"params": jax.tree.map(jnp.asarray, params)}, task, model


class Draws:
    """Stands in for rng.draw_normal in tasks/segmentation.py: hands out
    the given arrays in order, each of the shape the port asks for."""

    def __init__(self, *arrays):
        self.arrays = [np.asarray(a, np.float32) for a in arrays]

    def __call__(self, generators, shape, dtype=torch.float32, device=None):
        a = self.arrays.pop(0)
        assert a.size == int(np.prod(shape)), (a.shape, shape)
        return torch.as_tensor(a.reshape(shape), device=device)


def jax_loss_draws(jtask, rng, logits_shape, n, d):
    """The normals the JAX task's loss draws from `rng` (None: key(0))."""
    noise = jax.random.split(rng)[1] if rng is not None else jax.random.key(0)
    if isinstance(jtask, jseg.AleatoricUncertainty):
        return [jax.random.normal(noise, (jtask.iterations,) + logits_shape)]
    k1, k2 = jax.random.split(noise)
    half = (jtask.mc_samples + 1) // 2
    return [jax.random.normal(k1, (half, n, jtask.rank)), jax.random.normal(k2, (half, n, d))]


def assert_grads_close(jgrads, model):
    """Every leaf of the port's gradient within 1e-2 of the leaf's largest
    JAX value plus 1e-5 of the largest gradient of all."""
    ref = flax_to_torch_state(jax.tree.map(np.asarray, jgrads))
    grads = dict(model.named_parameters())
    assert set(ref) == set(grads)
    floor = 1e-5 * max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        scale = float(np.abs(g.numpy()).max())
        np.testing.assert_allclose(grads[name].grad.numpy(), g.numpy(), rtol=0,
                                   atol=floor + 1e-2 * scale, err_msg=name)


def test_metrics_match_jax():
    """dice_multiclass, soft_dice (one channel and three) and pixel_entropy
    within 1e-6."""
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 3, (2, 3, 16, 16)).astype(np.int32)
    target = rng.integers(0, 3, (2, 3, 16, 16)).astype(np.int32)
    labels = (0, 1, 2)
    np.testing.assert_allclose(
        tmetrics.dice_multiclass(torch.as_tensor(pred), torch.as_tensor(target), labels).numpy(),
        np.asarray(jmetrics.dice_multiclass(jnp.asarray(pred), jnp.asarray(target), labels)),
        rtol=1e-6)
    for c in (1, 3):
        probs = rng.dirichlet(np.ones(3), (4, 16, 16)).transpose(0, 3, 1, 2)[:, :c]
        probs = probs.astype(np.float32)
        tgt = target[0, :, :, :].repeat(2, 0)[:4] % (2 if c == 1 else 3)
        got = tmetrics.soft_dice(torch.as_tensor(probs), torch.as_tensor(tgt), c).numpy()
        ref = np.asarray(jmetrics.soft_dice(jnp.asarray(probs), jnp.asarray(tgt), c))
        assert got.shape == ref.shape == ((1,) if c == 1 else (2,))
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        np.testing.assert_allclose(tmetrics.pixel_entropy(torch.as_tensor(probs)).numpy(),
                                   np.asarray(jmetrics.pixel_entropy(jnp.asarray(probs))),
                                   rtol=1e-6, atol=1e-7)


def test_augment_inverses_match_jax():
    """un_apply_logits on the same parameters within 1e-5 of the logits'
    scale (standard normals: XLA contracts the coordinate arithmetic into
    fused multiply-adds, which moves a bilinear weight by an ulp),
    un_apply_keypoints within 1e-5 px; the keypoint inverse undoes
    `apply`'s keypoint transform."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 3, 64, 64)).astype(np.float32)
    kp = rng.uniform(5, 59, (6, 21, 2)).astype(np.float32)
    jparams = jaug.sample_params(jax.random.key(2), 6)
    tparams = taug.AugmentParams(*(torch.as_tensor(np.array(p)) for p in jparams))
    got = taug.un_apply_logits(torch.as_tensor(logits), tparams).numpy()
    ref = np.asarray(jaug.un_apply_logits(jnp.asarray(logits), jparams))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert np.abs(got).max() > 1.0
    got_kp = taug.un_apply_keypoints(torch.as_tensor(kp), tparams, (64, 64)).numpy()
    ref_kp = np.asarray(jaug.un_apply_keypoints(jnp.asarray(kp), jparams, (64, 64)))
    np.testing.assert_allclose(got_kp, ref_kp, rtol=0, atol=1e-5)
    moved = taug.apply({"img": torch.zeros(6, 1, 64, 64), "contour": torch.as_tensor(kp)},
                       tparams)["contour"]
    np.testing.assert_allclose(taug.un_apply_keypoints(moved, tparams, (64, 64)).numpy(), kp,
                               rtol=0, atol=1e-4)


HEAD_CASES = {
    "ssn rank 2, 3 classes": (3, dict(SMALL, ssn_rank=2)),
    "aleatoric sigma, 1 class, bf16 trunk": (1, dict(SMALL, ssn_rank=1, dtype="bfloat16")),
    "deep supervision with bias, 3 classes": (3, DEEP),
}


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_unet_heads_match_flax(case):
    """The UNet's SSN heads (sigma; the rank-major factor above rank 1,
    computed in the trunk dtype and emitted f32), and in training the
    deep-supervision heads (finest first) with `out_seg_bias`, through
    convert.py both ways: each output within 1e-4 of its scale (bf16: 2e-2)."""
    channels, kwargs = HEAD_CASES[case]
    jtask, jmodel, variables, task, model = make_pair(
        jseg.SegmentationUncertaintyTask, tseg.SegmentationUncertaintyTask, channels, kwargs)
    if kwargs.get("out_seg_bias"):  # the conversion must carry non-zero biases
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("Conv_0.bias") and ("OutputBlock" in name or "deep" in name):
                    p.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(1))
        variables = {"params": jax.tree.map(jnp.asarray, torch_to_flax_params(
            model.state_dict(), variables))}
    img = _batch(channels)["img"]
    train = bool(kwargs.get("deep_supervision"))
    ref = jax.jit(partial(jmodel.apply, train=train))(variables, jnp.asarray(img))
    with torch.no_grad():
        got = model(torch.as_tensor(img), train=train)
    pairs = [("out", got["out"], ref["out"])]
    pairs += [(f"ssn[{i}]", g, r) for i, (g, r) in enumerate(zip(got.get("ssn", []),
                                                                 ref.get("ssn", [])))]
    pairs += [(f"ds[{i}]", g, r) for i, (g, r) in enumerate(
        zip(got.get("deep_supervision", []), ref.get("deep_supervision", [])))]
    expected = {"ssn rank 2, 3 classes": 3, "aleatoric sigma, 1 class, bf16 trunk": 2,
                "deep supervision with bias, 3 classes": 3}[case]
    assert len(pairs) == expected and set(got) == set(ref)
    bar = 2e-2 if kwargs.get("dtype") == "bfloat16" else 1e-4
    for name, g, r in pairs:
        r = np.asarray(r, np.float32)
        assert tuple(g.shape) == r.shape, name
        if name.startswith("ssn"):
            assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=bar * np.abs(r).max(),
                                   err_msg=name)
    if train:
        assert [tuple(h.shape[-2:]) for h in got["deep_supervision"]] == [(32, 32), (16, 16)]
        assert "deep_supervision" not in model(torch.as_tensor(img))


@pytest.mark.parametrize("channels", [1, 3])
def test_compute_loss_matches_jax(channels):
    """compute_loss (CE + soft Dice) on the same logits within 1e-5
    relative, and its gradient with respect to the logits."""
    rng = np.random.default_rng(channels)
    y = _batch(channels)["gt"]
    logits = rng.normal(size=(4, channels, 64, 64)).astype(np.float32)
    jtask = jseg.SegmentationUncertaintyTask(data_params=_dp(channels, True))
    task = tseg.SegmentationUncertaintyTask(data_params=_dp(channels))
    (jloss, (jce, jdice)), jgrad = jax.value_and_grad(
        lambda l: (lambda out: (out[0], out[1:]))(jtask.compute_loss(jnp.asarray(y), l)),
        has_aux=True)(jnp.asarray(logits))
    t_logits = torch.as_tensor(logits).requires_grad_(True)
    loss, ce, dice = task.compute_loss(torch.as_tensor(y), t_logits)
    loss.backward()
    for got, ref in ((loss, jloss), (ce, jce), (dice, jdice)):
        np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(t_logits.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jgrad)).max()))


LOSS_CASES = {
    "segmentation, deep supervision, 3 classes": (jseg.SegmentationUncertaintyTask,
                                                  tseg.SegmentationUncertaintyTask, 3, DEEP, {}),
    "mcdropout, 1 class": (jseg.McDropoutUncertainty, tseg.McDropoutUncertainty, 1,
                           dict(SMALL, drop_block=False), {}),
    "aleatoric, 1 class": (jseg.AleatoricUncertainty, tseg.AleatoricUncertainty, 1, SMALL,
                           dict(iterations=3)),
    "aleatoric, 3 classes": (jseg.AleatoricUncertainty, tseg.AleatoricUncertainty, 3, SMALL,
                             dict(iterations=3)),
    "ssn, 1 class": (jseg.StochasticSegmentationNetwork, tseg.StochasticSegmentationNetwork, 1,
                     SMALL, dict(rank=2, mc_samples=5)),
    "ssn, 3 classes": (jseg.StochasticSegmentationNetwork, tseg.StochasticSegmentationNetwork,
                       3, SMALL, dict(rank=2, mc_samples=5)),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_task_loss_val_metrics_and_gradients_match_jax(case, monkeypatch):
    """Each task's loss(train=True) and its gradient for every parameter,
    and val_metrics (the JAX tasks' key(0) draws), against the JAX task's
    with the same draws: logs within 1e-5 relative, gradients per leaf as
    the module docstring states."""
    jcls, tcls, channels, kwargs, task_kwargs = LOSS_CASES[case]
    jtask, jmodel, variables, task, model = make_pair(jcls, tcls, channels, kwargs,
                                                      **task_kwargs)
    assert model.drop_block is False and (task.model_kwargs.get("ssn_rank", 0)
                                          == jtask.model_kwargs.get("ssn_rank", 0))
    batch = _batch(channels)
    jbatch = jax.tree.map(jnp.asarray, batch)
    n, d = 4, channels * 64 * 64
    rng = jax.random.key(7)

    def jloss(params, train, key):
        return jtask.loss(jmodel, {"params": params}, jbatch, key, train=train)

    @jax.jit
    def both(params):  # one compile for the training gradient and the validation logs
        grads = jax.value_and_grad(partial(jloss, train=True, key=rng), has_aux=True)(params)
        return grads, jloss(params, False, None)[1]

    ((_, jlogs), jgrads), jval = both(variables["params"])
    stochastic = isinstance(jtask, (jseg.AleatoricUncertainty, jseg.StochasticSegmentationNetwork))
    if stochastic:
        monkeypatch.setattr(tseg, "draw_normal", Draws(
            *jax_loss_draws(jtask, rng, (n, channels, 64, 64), n, d),
            *jax_loss_draws(jtask, None, (n, channels, 64, 64), n, d)))
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    model.train()
    model.zero_grad(set_to_none=True)
    loss, logs = task.loss(model, tbatch, torch.Generator().manual_seed(0), train=True)
    loss.backward()
    model.eval()
    with torch.no_grad():
        val = task.val_metrics(model, tbatch)
    assert set(logs) == set(jlogs) == set(val) == set(jval) == {"loss", "ce", "dice"}
    for got, ref in ((logs, jlogs), (val, jval)):
        for key in ref:
            np.testing.assert_allclose(float(got[key].detach()), float(ref[key]), rtol=1e-5,
                                       err_msg=key)
    assert_grads_close(jgrads, model)
    if kwargs.get("deep_supervision"):  # the ladder moved the loss
        plain, _, _ = task.compute_loss(tbatch["gt"], model(tbatch["img"])["out"])
        assert abs(float(plain) - float(logs["loss"])) > 1e-4


@pytest.mark.parametrize("antithetic", [True, False])
def test_ssn_distribution_and_samples_match_jax(antithetic, monkeypatch):
    """SSN's _distribution_params at 3 classes and rank 2 (the factor head's
    channels rank-major: channel r*C + c) within 1e-4 of their scale, and
    _sample_logits on the same parameters and draws within 1e-5 (5 draws:
    antithetic ones keep concat([dev, -dev])[:5])."""
    jtask, jmodel, variables, task, model = make_pair(
        jseg.StochasticSegmentationNetwork, tseg.StochasticSegmentationNetwork, 3, SMALL,
        rank=2)
    img = _batch(3, n=2)["img"]
    jout = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        tout = model(torch.as_tensor(img))
    jparams = jtask._distribution_params(jout)
    tparams = task._distribution_params(tout)
    for name, g, r in zip(("mean", "diag", "factor"), tparams, jparams):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)
    factor = np.asarray(tout["ssn"][1]).reshape(2, 2, 3, -1)  # (n, rank, class, H*W)
    np.testing.assert_array_equal(tparams[2][:, 64 * 64:2 * 64 * 64, 1].numpy(),
                                  factor[:, 1, 1])
    key = jax.random.key(11)
    ref = np.asarray(jtask._sample_logits(key, *jparams, 5, antithetic=antithetic))
    half = 3 if antithetic else 5
    k1, k2 = jax.random.split(key)
    monkeypatch.setattr(tseg, "draw_normal", Draws(
        jax.random.normal(k1, (half, 2, 2)), jax.random.normal(k2, (half, 2, 3 * 64 * 64))))
    got = task._sample_logits(None, *(torch.as_tensor(np.asarray(p)) for p in jparams), 5,
                              antithetic=antithetic).numpy()
    assert got.shape == ref.shape == (5, 2, 3 * 64 * 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if antithetic:
        mean = np.asarray(jparams[0])
        np.testing.assert_allclose(got[3] - mean, -(got[0] - mean), rtol=0, atol=1e-5)


def _nested(size=32):
    """Nested rings: a ring with a hole holding a blob with its own hole."""
    yy, xx = np.mgrid[:size, :size]
    r = np.hypot(yy - size / 2, xx - size / 2)
    return (((r < 14) & (r > 10)) | ((r < 7) & (r > 3))).astype(np.float32)


def _tie(size=32):
    m = np.zeros((size, size), np.float32)
    m[3:7, 3:7] = 1  # 16 px
    m[20:24, 10:14] = 1  # 16 px, larger labels
    m[12, 25] = 1
    return m


MASKS = {
    "random": lambda: (np.random.default_rng(0).uniform(size=(3, 4, 32, 32)) > 0.55
                       ).astype(np.float32),
    "nested holes": lambda: np.stack([_nested(), 1 - _nested()]),
    "equal-size tie": lambda: np.stack([_tie(), _tie()[::-1].copy(), _tie().T.copy()]),
    "empty": lambda: np.zeros((2, 32, 32), np.float32),
}


@pytest.mark.parametrize("case", list(MASKS))
def test_morphology_matches_jax_bitwise(case):
    """fill_holes, largest_blob and postprocess_batch on the same masks,
    bitwise against the JAX package (vmapped over the leading axes), and
    against scipy's binary_fill_holes and label (4-connected) where no two
    largest components tie. An empty mask stays empty."""
    masks = MASKS[case]()
    flat = masks.reshape(-1, *masks.shape[-2:])
    t = torch.as_tensor(masks)
    for name in ("fill_holes", "largest_blob"):
        ref = np.stack([np.asarray(getattr(jmorph, name)(jnp.asarray(m))) for m in flat])
        got = getattr(tmorph, name)(t)
        assert got.dtype == t.dtype and got.shape == t.shape
        np.testing.assert_array_equal(got.numpy().reshape(flat.shape), ref, err_msg=name)
        assert tmorph.iterations[name] > 0
    ref = np.asarray(jmorph.postprocess_batch(jnp.asarray(masks)))
    got = tmorph.postprocess_batch(t).numpy()
    np.testing.assert_array_equal(got, ref)
    filled = np.stack([ndimage.binary_fill_holes(m) for m in flat])
    np.testing.assert_array_equal(tmorph.fill_holes(t).numpy().reshape(flat.shape), filled)
    for m, out in zip(filled, got.reshape(flat.shape)):
        labels, count = ndimage.label(m)
        sizes = np.bincount(labels.ravel())[1:]
        if count == 0:
            assert out.sum() == 0
        elif (sizes == sizes.max()).sum() == 1:
            np.testing.assert_array_equal(out, labels == 1 + sizes.argmax())
        else:  # the tie goes to the component whose largest pixel id is smallest
            best = min((np.flatnonzero(labels.ravel() == i + 1).max(), i + 1)
                       for i in np.flatnonzero(sizes == sizes.max()))[1]
            np.testing.assert_array_equal(out, labels == best)
            assert case == "equal-size tie"
