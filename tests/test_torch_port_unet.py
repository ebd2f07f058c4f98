"""PyTorch port vs JAX package: the UNet, the weight converter and the
DSNT-AL task's forward (models/unet.py, convert.py, tasks/dsnt_al.py).

The flax model is initialised from a seed; its parameters reach the port
through convert.flax_to_torch_state, so both sides run the same weights.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
from contouring_uncertainty_tpu.models import UNet as JUNet
from contouring_uncertainty_tpu.tasks import DSNTAleatoric as JTask
from contouring_uncertainty_torch.convert import flax_to_torch_state
from contouring_uncertainty_torch.data.config import DataParams
from contouring_uncertainty_torch.models import build_backbone
from contouring_uncertainty_torch.tasks import DSNTAleatoric
from contouring_uncertainty_torch.tasks.dsnt_al import mc_dropout_apply

torch.set_num_threads(1)

SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3)
SHAPES = dict(input_shape=(1, 64, 64), output_shape=(21, 64, 64))


@pytest.fixture(scope="module")
def flax_small():
    model = JUNet(**SHAPES, **SMALL, drop_block=True)
    img = np.random.default_rng(0).normal(size=(2, 1, 64, 64)).astype(np.float32)
    variables = jax.jit(model.init)(jax.random.key(3), jnp.asarray(img))
    params = jax.tree.map(np.asarray, variables["params"])
    return model, variables, params, img


def _port(params, **kw):
    model = build_backbone("unet2", SHAPES["input_shape"], SHAPES["output_shape"],
                           **SMALL, drop_block=True, **kw)
    model.load_state_dict(flax_to_torch_state(params), strict=True)
    return model.eval()


def test_unet_logits_match_flax(flax_small):
    """Deterministic f32 logits within 2e-4 of flax (the bar of the JAX
    package's own reference-model parity test): every conv shape and
    padding, instance-norm formula, transposed-conv orientation and
    skip-concat order must line up. The strict state_dict load checks that
    the converter fills every parameter and nothing else."""
    model, variables, params, img = flax_small
    ref = np.asarray(model.apply(variables, jnp.asarray(img))["out"])
    with torch.no_grad():
        got = _port(params)(torch.as_tensor(img))["out"].numpy()
    assert got.shape == ref.shape == (2, 21, 64, 64)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


def test_bf16_serving_unet_tracks_f32(flax_small):
    """dtype=bf16 + head_dtype=bf16 (the serving mode) emits bf16 logits
    that stay within bf16 rounding of the f32 network (relative to the
    logits' spread), and the prefix modes carry the compute dtype."""
    _, _, params, img = flax_small
    with torch.no_grad():
        f32 = _port(params)(torch.as_tensor(img))["out"]
        bf16 = _port(params, dtype="bfloat16", head_dtype="bfloat16")(
            torch.as_tensor(img))["out"]
    assert bf16.dtype == torch.bfloat16
    assert float((bf16.float() - f32).abs().max() / f32.std()) < 0.1


def test_prefix_sharing_matches_tiled_forward(flax_small):
    """mc_dropout_apply (encoder prefix once at batch N, tiled T_e times)
    equals the full forward of the tiled input with the same generator seed:
    the prefix has no dropout and the tail draws the same channel masks in
    the same order. Exact up to conv reduction order at different batch
    sizes (1e-5, as the JAX package's own prefix test)."""
    _, _, params, img = flax_small
    model = _port(params)
    x = torch.as_tensor(img)
    with torch.no_grad():
        shared = mc_dropout_apply(model, x, 3, torch.Generator().manual_seed(5))["out"]
        tiled = model(x.repeat(3, 1, 1, 1), deterministic=False,
                      generator=torch.Generator().manual_seed(5))["out"]
    torch.testing.assert_close(shared, tiled, rtol=0, atol=1e-5)
    assert float((shared[:2] - shared[2:4]).abs().max()) > 0  # dropout is live


def test_task_forward_matches_jax_and_backbone_flags(flax_small):
    """DSNTAleatoric.predict at T_e=1 (deterministic) against the JAX task
    on the same weights: mu within 1e-3 px and Sigma within 1e-3 of its
    scale (logit differences of ~1e-5 through the softmax moments). The
    other backbones and the UNet's residual flag build."""
    _, variables, params, img = flax_small
    dp = dict(in_shape=(1, 64, 64), out_shape=(21, 2))
    jtask = JTask(data_params=JDataParams(**dp), t_e=1,
                  model_kwargs={**SMALL, "drop_block": True})
    mu_j, cov_j = jtask.predict(jtask.build_model(), variables, jnp.asarray(img),
                                rng=jax.random.key(0))
    task = DSNTAleatoric(data_params=DataParams(**dp), t_e=1,
                         model_kwargs={**SMALL, "drop_block": True})
    model = task.build_model(device="cpu")
    model.load_state_dict(flax_to_torch_state(params))
    with torch.no_grad():
        mu_t, cov_t = task.predict(model, torch.as_tensor(img))
    assert mu_t.shape == (2, 1, 21, 2) and cov_t.shape == (2, 1, 21, 2, 2)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-3)
    cov_j = np.asarray(cov_j)
    assert np.abs(cov_t.numpy() - cov_j).max() / np.abs(cov_j).max() < 1e-3

    # The two flags and the backbone that raised before item 9 was ported
    # build; a key a backbone does not take is dropped, as in JAX.
    assert build_backbone("unet2", (1, 64, 64), (21, 64, 64), **SMALL,
                          residual=True).block_name == "ResidBlock"
    enet = build_backbone("enet", (1, 64, 64), (21, 64, 64), residual=True, head_dtype="bfloat16")
    assert type(enet).__name__ == "Enet"
    with pytest.raises(ValueError, match="Unknown"):
        build_backbone("vnet", (1, 64, 64), (21, 64, 64))
