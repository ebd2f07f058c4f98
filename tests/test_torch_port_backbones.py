"""PyTorch port vs JAX package: the other backbones (models/deeplabv3.py,
models/resnet.py, models/enet.py), the UNet's residual and attention flags
(models/unet.py), their weight conversion (convert.py) and the tasks that
take them (tasks/dsnt_al.py, tasks/epistemic.py, tasks/dsnt_skew.py).

Each model is a small-depth instance at 64^2 (DeepLab base 8 with one or
two blocks a stage, ENet init_channels 8, ResNet one block a stage, a
4-stage UNet), initialised by the port from a seed and put on the flax
tree (`to_flax`, whose round trip through convert.flax_to_torch_state is
checked bitwise); flax runs eagerly, and jitted where it draws dropout. Stochastic
forwards get JAX's own dropout masks: the channels each flax Dropout kept,
in call order, handed to the port's dropout as its uniforms.

Tolerances: every output (out, heads, ssn, bottleneck, sigma) within
3e-4 of the reference's largest magnitude (measured up to 1.0e-4, ENet's
26 normalised blocks; 2e-5 for DeepLab and the UNet); the DSNT-AL loss within 1e-5
relative, each gradient leaf within 1e-3 of its largest magnitude (measured
3e-5), and within 1e-7 (1e-6 for the heatmap bias, which the softmax
ignores) where the exact gradient is zero;
regression_gaussians within 1e-6; mu within 1e-3 px and covariances within
1e-3 of their scale.
"""

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
from contouring_uncertainty_tpu.models import build_backbone as jbuild
from contouring_uncertainty_tpu.tasks import DSNTAleatoric as JTask
from contouring_uncertainty_tpu.tasks import dsnt_al as jdsnt_al
from contouring_uncertainty_tpu.tasks.dsnt_skew import DSNTSkew as JSkew
from contouring_uncertainty_tpu.tasks.epistemic import EpistemicUncertainty as JEpistemic
from contouring_uncertainty_torch.convert import flax_to_torch_state
from contouring_uncertainty_torch.data.config import DataParams
from contouring_uncertainty_torch.models import build_backbone
from contouring_uncertainty_torch.models import layers as tlayers
from contouring_uncertainty_torch.tasks import DSNTAleatoric, DSNTSkew
from contouring_uncertainty_torch.tasks import dsnt_al as tdsnt_al
from contouring_uncertainty_torch.tasks.dsnt_al import mc_dropout_apply
from contouring_uncertainty_torch.tasks.epistemic import EpistemicUncertainty
from test_torch_port_seg_predict import capture_masks, masks_as_uniforms

torch.set_num_threads(1)

SIZE = 64
SMALL_UNET = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3)
MODELS = {
    "deeplabv3 heads bottleneck": ("deeplabv3", dict(base=8, layers=(1, 1, 1, 1), n_heads=2,
                                                     bottleneck_out=True, dropout=0.3), 3),
    "deeplabv3 ssn": ("deeplabv3", dict(base=8, layers=(1, 2, 1, 1), ssn_rank=2,
                                        dropout=0.3), 3),
    "resnet sigma": ("resnet", dict(layers=(1, 1, 1, 1), sigma_out=3, dropout=0.3), None),
    "enet ssn bottleneck": ("enet", dict(init_channels=8, ssn_rank=2, bottleneck_out=True,
                                         dropout=0.3), 3),
    "enet prelu heads": ("enet", dict(init_channels=8, encoder_relu=False, decoder_relu=False,
                                      n_heads=2, dropout=0.3), 3),
    "unet residual attention": ("unet2", dict(SMALL_UNET, residual=True, attention=True,
                                              drop_block=True, bottleneck_out=True), 21),
}
TOL = 3e-4


def _img(n=2, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 1, SIZE, SIZE)).astype(np.float32)


def to_flax(state, like):
    """The inverse of convert.flax_to_torch_state (rank-dispatched): the
    port's `state_dict` as a flax parameter tree shaped like `like` (from
    `jax.eval_shape(model.init, ...)`), as nested dicts of f32 arrays."""
    if "params" in like and len(like) == 1:
        like = like["params"]

    def walk(tree, path):
        out = {}
        for name, value in tree.items():
            if not hasattr(value, "shape"):
                out[name] = walk(value, path + [name])
                continue
            prefix = ".".join(path)
            t = state[f"{prefix}.{'weight' if name in ('kernel', 'scale') else name}"]
            t = t.detach().to(torch.float32)
            if name == "kernel" and t.dim() == 2:
                t = t.t()
            elif name == "kernel" and path[-1].startswith("ConvTranspose"):
                t = t.permute(2, 3, 0, 1).flip(0).flip(1)
            elif name == "kernel":
                t = t.permute(2, 3, 1, 0)
            arr = t.contiguous().numpy()
            assert arr.shape == tuple(value.shape), (prefix, name, arr.shape, value.shape)
            out[name] = jnp.asarray(arr)
        return out

    return walk(like, [])


def _flax_variables(jmodel, model):
    """flax variables holding the port model's weights; the round trip
    through convert.flax_to_torch_state gives them back bitwise."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((2, 1, SIZE, SIZE)))
    params = to_flax(model.state_dict(), shapes)
    back = flax_to_torch_state(jax.tree.map(np.asarray, params))
    assert set(back) == set(model.state_dict())
    for name, value in model.state_dict().items():
        assert torch.equal(back[name], value), name
    return {"params": params}


def _pair(name, kwargs, channels, seed=1):
    """(flax model, variables, port model) with the port's seeded weights."""
    out_shape = (21, 2) if channels is None else (channels, SIZE, SIZE)
    jmodel = jbuild(name, (1, SIZE, SIZE), out_shape, **kwargs)
    model = build_backbone(name, (1, SIZE, SIZE), out_shape, **kwargs)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return jmodel, _flax_variables(jmodel, model), model.eval()


def _assert_outputs_close(got, ref, tol=TOL):
    """Same keys; each array (or list of arrays) within tol of the
    reference's largest magnitude; the bottleneck compared in NCHW."""
    assert set(got) == set(ref), (set(got), set(ref))
    for key in ref:
        pairs = zip(got[key], ref[key]) if isinstance(ref[key], list) else [(got[key], ref[key])]
        for g, r in pairs:
            r = np.asarray(r)
            if key == "bottleneck":
                r = r.transpose(0, 3, 1, 2)
            g = g.detach().numpy()
            assert g.shape == r.shape and g.dtype == np.float32, (key, g.shape, r.shape)
            assert np.abs(g - r).max() <= tol * np.abs(r).max(), (key, np.abs(g - r).max())


@pytest.mark.parametrize("case", list(MODELS))
def test_backbone_forward_matches_flax(case, monkeypatch):
    """Deterministic outputs, then a dropout forward with JAX's masks, of
    each backbone against flax on the same weights."""
    name, kwargs, channels = MODELS[case]
    jmodel, variables, model = _pair(name, kwargs, channels)
    img = _img()
    ref = jax.tree.map(np.asarray, jmodel.apply(variables, jnp.asarray(img)))
    with torch.no_grad():
        _assert_outputs_close(model(torch.as_tensor(img)), ref)

    ref, masks = capture_masks(lambda v, x, k: jmodel.apply(
        v, x, deterministic=False, rngs={"dropout": k}))(variables, jnp.asarray(img),
                                                          jax.random.key(7))
    assert masks and not all(m.all() for m in masks)  # dropout is live
    monkeypatch.setattr(tlayers, "draw_uniform", masks_as_uniforms(masks))
    with torch.no_grad():
        got = model(torch.as_tensor(img), deterministic=False)
    _assert_outputs_close(got, ref)


def test_enet_transposed_conv_matches_flax_same_padding():
    """flax ConvTranspose(k=3, s=2, "SAME") against the port's cropped
    unpadded transposed conv on a 5x6 input, exactly up to f32 rounding
    (torch's padding=1, output_padding=1 is off by a pixel there)."""
    x = np.random.default_rng(2).normal(size=(2, 5, 6, 4)).astype(np.float32)
    layer = fnn.ConvTranspose(3, (3, 3), strides=(2, 2), padding="SAME", use_bias=False)
    variables = layer.init(jax.random.key(0), jnp.asarray(x))
    ref = np.asarray(layer.apply(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    conv = tlayers.ConvTranspose(4, 3, (2, 2), kernel_size=(3, 3), padding="SAME")
    state = flax_to_torch_state({"ConvTranspose_0": jax.tree.map(np.asarray,
                                                                 variables["params"])})
    conv.weight.data = state["ConvTranspose_0.weight"]
    with torch.no_grad():
        got = conv(torch.as_tensor(x.transpose(0, 3, 1, 2))).numpy()
    assert got.shape == ref.shape == (2, 3, 10, 12)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_residual_unet_prefix_sharing_is_exact():
    """mc_dropout_apply with residual and attention blocks (the encoder
    prefix once, tiled) equals the tiled input's forward with the same
    generator: the prefix has no dropout, and the tail draws the same
    masks in the same order (1e-5, the conv reduction order at two batch
    sizes)."""
    _, _, model = _pair("unet2", MODELS["unet residual attention"][1], 21)
    x = torch.as_tensor(_img())
    with torch.no_grad():
        shared = mc_dropout_apply(model, x, 3, torch.Generator().manual_seed(5))
        tiled = model(x.repeat(3, 1, 1, 1), deterministic=False,
                      generator=torch.Generator().manual_seed(5))
    for key in ("out", "bottleneck"):
        torch.testing.assert_close(shared[key], tiled[key], rtol=0, atol=1e-5)
    assert float((shared["out"][:2] - shared["out"][2:4]).abs().max()) > 0


def test_regression_gaussians_match_jax():
    """The Resnet head's (mu, cov) from (log sigma_x, log sigma_y, rho
    logit), with and without the correlation, clipped log sigmas."""
    rng = np.random.default_rng(4)
    mu = rng.normal(size=(3, 21, 2)).astype(np.float32)
    sig = (rng.normal(size=(3, 21, 3)) * 4).astype(np.float32)
    for covar in (True, False):
        for params in (sig, sig[..., :2]):
            ref = jdsnt_al.regression_gaussians(jnp.asarray(mu), jnp.asarray(params), covar)
            got = tdsnt_al.regression_gaussians(torch.as_tensor(mu), torch.as_tensor(params),
                                                covar)
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def _tasks(model_name, model_kwargs, jcls=JTask, tcls=DSNTAleatoric, **kw):
    dp = dict(in_shape=(1, SIZE, SIZE), out_shape=(21, 2))
    jtask = jcls(data_params=JDataParams(**dp), model_name=model_name,
                 model_kwargs=dict(model_kwargs), **kw)
    task = tcls(data_params=DataParams(**dp), model_name=model_name,
                model_kwargs=dict(model_kwargs), **kw)
    return jtask, task


def _task_pair(model_name, model_kwargs, **kw):
    jtask, task = _tasks(model_name, model_kwargs, **kw)
    jmodel = jtask.build_model()
    model = task.build_model(device="cpu", generator=torch.Generator().manual_seed(2))
    return jtask, jmodel, _flax_variables(jmodel, model), task, model


def test_dsnt_al_loss_and_gradients_match_jax_on_deeplabv3():
    """DSNTAleatoric.loss on DeepLabV3 (train mode, no dropout): the loss and
    its logs within 1e-5 relative, every gradient leaf within 1e-3 of its
    largest magnitude."""
    jtask, jmodel, variables, task, model = _task_pair(
        "deeplabv3", dict(base=8, layers=(1, 1, 1, 1)))
    img = _img(4, seed=3)
    contour = (np.random.default_rng(5).uniform(10, 54, size=(4, 21, 2))).astype(np.float32)
    batch = {"img": jnp.asarray(img), "contour": jnp.asarray(contour)}
    (loss_j, logs_j), grads_j = jax.jit(jax.value_and_grad(
        lambda v: jtask.loss(jmodel, v, batch, jax.random.key(0), train=True),
        has_aux=True))(variables)
    model.train()
    loss, logs = task.loss(model, {k: torch.as_tensor(np.array(v)) for k, v in batch.items()},
                           train=True)
    loss.backward()
    for key, value in logs_j.items():
        np.testing.assert_allclose(float(logs[key].detach()), float(value), rtol=1e-5)
    grads = flax_to_torch_state(jax.tree.map(np.asarray, grads_j["params"]))
    for name, param in model.named_parameters():
        ref, got = grads[name].numpy(), param.grad.numpy()
        if not ref.any():
            # ASPP's pooled branch: its norm sees a 1x1 map and gives its
            # bias (0 at init), whose ReLU passes no gradient at 0.
            assert name.startswith(("ASPP_0.Conv_4.", "ASPP_0.GroupNorm_4.")), name
            assert np.abs(got).max() <= 1e-7, (name, np.abs(got).max())
            continue
        if name == "head_out_0.bias":
            # The heatmap softmax ignores a per-channel shift: both gradients
            # are rounding noise around 0.
            assert max(np.abs(ref).max(), np.abs(got).max()) <= 1e-6, name
            continue
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= 1e-3, (name, err)


@pytest.mark.parametrize("model_name,kwargs", [
    ("resnet", dict(layers=(1, 1, 1, 1), dropout=0.3)),
    ("enet", dict(init_channels=8, dropout=0.3)),
])
def test_dsnt_al_mc_predict_matches_jax(model_name, kwargs, monkeypatch):
    """DSNTAleatoric.predict at T_e = 2 on a backbone that is not a UNet:
    the tiled-input MC-dropout forward (JAX's masks handed to the port),
    then DSNT (ENet) or regression_gaussians (Resnet, sigma_out 3 by
    default): mu within 1e-3 px, cov within 1e-3 of its scale."""
    jtask, jmodel, variables, task, model = _task_pair(model_name, kwargs, t_e=2)
    img = _img(2, seed=6)
    (mu_j, cov_j), masks = capture_masks(lambda v, x, k: jtask.predict(jmodel, v, x, rng=k))(
        variables, jnp.asarray(img), jax.random.key(9))
    monkeypatch.setattr(tlayers, "draw_uniform", masks_as_uniforms(masks))
    with torch.no_grad():
        mu, cov = task.predict(model, torch.as_tensor(img))
    assert mu.shape == (2, 2, 21, 2) and cov.shape == (2, 2, 21, 2, 2)
    np.testing.assert_allclose(mu.numpy(), mu_j, atol=1e-3)
    assert np.abs(cov.numpy() - cov_j).max() <= 1e-3 * np.abs(cov_j).max()
    assert float((mu[:, 0] - mu[:, 1]).abs().max()) > 1e-4  # dropout is live


@pytest.mark.parametrize("model_name,kwargs", [
    ("deeplabv3", dict(base=8, layers=(1, 1, 1, 1))),
    ("enet", dict(init_channels=8, dropout=0.0)),
])
def test_skew_head_on_other_backbones_matches_jax(model_name, kwargs):
    """DSNTSkew on DeepLabV3 and ENet: the ConfidenceNet sized from the
    backbone's bottleneck shape, its alpha_raw and the heatmaps within the
    outputs' tolerance of flax."""
    jtask, jmodel, variables, task, model = _task_pair(model_name, kwargs, jcls=JSkew,
                                                       tcls=DSNTSkew)
    img = _img()
    ref = jax.tree.map(np.asarray, jmodel.apply(variables, jnp.asarray(img)))
    with torch.no_grad():
        got = model(torch.as_tensor(img))
    _assert_outputs_close(got, ref)


def test_epistemic_forces_dropout_on_other_backbones(capsys):
    """At T_e > 1 the epistemic task sets dropout=0.1 where the config has
    none, on every backbone that is not a UNet, as the JAX task does; a
    configured rate stays."""
    for model_name, kwargs in (("enet", dict(init_channels=8, dropout=0.0)),
                               ("deeplabv3", dict(base=8, layers=(1, 1, 1, 1))),
                               ("resnet", dict(layers=(1, 1, 1, 1), dropout=0.2))):
        jtask, task = _tasks(model_name, kwargs, jcls=JEpistemic, tcls=EpistemicUncertainty,
                             t_e=3)
        jtask.build_model()
        model = task.build_model(device="cpu")
        assert task.model_kwargs == jtask.model_kwargs
        assert task.model_kwargs["dropout"] == (0.2 if model_name == "resnet" else 0.1)
        rates = {m.dropout for m in model.modules() if isinstance(getattr(m, "dropout", None),
                                                                     float)}
        assert task.model_kwargs["dropout"] in rates
    assert capsys.readouterr().out.count("forcing model dropout=0.1") == 4
