"""PyTorch port vs JAX package: run_predict with the sequence sampler, with
soft masks, and with several views per dispatch (predict.py
`predict_batch_views`, `AleatoricPredictor.batched`).

The JAX comparisons run both packages' run_predict on the same synthetic
views (7 patients at 64^2: 4 test views of an ED and an ES frame), the same
flax weights (converted for the port), T_e = 1 (a deterministic forward)
and the same fixed logit map added to the heatmaps, so the untrained
4-stage UNet gives meaningful contours; the sampled outputs come from other
RNG streams and are compared in distribution. The port's batched path is
also held to its own one-view-per-dispatch path with MC dropout live
(T_e = 2), within the JAX package's batching budgets
(tests/test_parallel.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
from contouring_uncertainty_tpu.predict import run_predict as j_run_predict
from contouring_uncertainty_tpu.tasks import DSNTAleatoric as JTask
from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch.convert import flax_to_torch_state
from contouring_uncertainty_torch.data.synthetic import synthetic_camus_data
from contouring_uncertainty_torch.tasks import DSNTAleatoric, DSNTSkew
from contouring_uncertainty_torch.utils.umap import skew_umap_groups
from test_torch_port_skew_predict import _ViewBias

torch.set_num_threads(1)

SIZE = 64
T_A = 128
SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3, drop_block=True)


@pytest.fixture(scope="module")
def setup():
    """The views, the biased JAX task and weights, and the port's task and
    biased model with the same weights."""
    data = synthetic_camus_data(n_patients=7, size=SIZE, seed=2)
    views = list(data.predict_views("test"))
    assert len(views) == 4
    bias = _ViewBias(views)
    dp = JDataParams(in_shape=(1, SIZE, SIZE), out_shape=(21, 2))
    jtask = JTask(data_params=dp, t_e=1, t_a=T_A, model_kwargs=SMALL)
    junet = jtask.build_model()
    variables = jax.jit(junet.init)(jax.random.key(3), jnp.asarray(views[0]["img"]))

    class JBiased:
        def apply(self, v, x, **kw):
            return {"out": junet.apply(v, x, **kw)["out"] + bias.jax(x)}

    jtask.build_model = lambda: JBiased()
    task = DSNTAleatoric(data_params=data.data_params, t_e=1, t_a=T_A, model_kwargs=SMALL)
    unet = task.build_model(device="cpu")
    unet.load_state_dict(flax_to_torch_state(jax.tree.map(np.asarray, variables["params"])))

    class TBiased(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.unet = unet

        def forward(self, x, **kw):
            return {"out": self.unet(x, **kw)["out"] + bias.torch(x)}

    return data, jtask, variables, task, TBiased()


@pytest.fixture(scope="module")
def both_options(setup):
    """The port's and the JAX package's run_predict with task.sequence_sampler
    (the sequence prior fit on the train split's (ED, ES) pairs) and
    task.soft_mask together, at predict_batch_views = 3 over the 4 views (a
    dispatch of 3, then one of 1): one JAX compile serves both options'
    checks."""
    data, jtask, variables, task, model = setup
    cfg = {"seed": 3, "predict_batch_views": 3,
           "task": {"sequence_sampler": True, "soft_mask": True}}
    ref = j_run_predict(jtask, variables, data, cfg)
    got = tpred.run_predict(task, model, data, cfg, device="cpu")
    assert [g.id for g in got] == [r.id for r in ref] == [
        v["id"] for v in data.predict_views("test")]
    for g, r in zip(got, ref):
        for key in ("mu", "cov", "post_mu", "post_cov", "contour_samples", "pred_samples",
                    "pred", "uncertainty_map", "entropy_map"):
            a, b = getattr(g, key), np.asarray(getattr(r, key))
            assert a.shape == b.shape and a.dtype == b.dtype, key
    return got, ref


def _assert_contours_match_jax(got, ref):
    """One view's contour outputs against the JAX package's: mu within 1e-4
    px and cov within 1e-3 of its scale (the two frameworks' f32
    convolutions and moment sums round differently); in distribution (T_a =
    128 per frame, other RNG streams) post_mu within 5 joint standard
    errors."""
    np.testing.assert_allclose(got.mu, ref.mu, atol=1e-4)
    assert np.abs(got.cov - ref.cov).max() < 1e-3 * np.abs(ref.cov).max()
    var_j = np.einsum("nkii->nki", ref.post_cov)
    var_t = np.einsum("nkii->nki", got.post_cov)
    assert (np.abs(got.post_mu - ref.post_mu) < 5 * np.sqrt((var_j + var_t) / T_A)).all()


def _assert_soft_masks_match_jax(got, ref):
    """One view's soft-mask outputs against the JAX package's: the
    uncertainty map as in test_torch_port_predict; in distribution, the mean
    occupancy of the sample masks (f32 in [0, 1]) within 5 standard errors,
    the prediction equal wherever that occupancy is more than 5 standard
    errors from 0.5, and the summed entropy within 15%."""
    umap_t, umap_j = got.uncertainty_map, np.asarray(ref.uncertainty_map)
    assert (np.abs(umap_t - umap_j) > 1e-6).mean() <= 1e-3
    occ = [np.asarray(p.pred_samples, np.float64) for p in (got, ref)]
    assert all(o.min() >= 0.0 and o.max() <= 1.0 for o in occ)
    var = sum(o.var(axis=(1, 2)) for o in occ) / T_A
    mean = [o.mean(axis=(1, 2)) for o in occ]
    se = np.sqrt(np.maximum(var, 1.0 / T_A ** 2))
    assert (np.abs(mean[0] - mean[1]) <= 5 * se).all()
    assert (np.asarray(ref.pred).sum(axis=(1, 2)) > 100).all()
    # The prediction differs only where the occupancy is within 5 standard
    # errors of the 0.5 threshold.
    undecided = np.abs((mean[0] + mean[1]) / 2 - 0.5) <= 5 * se
    assert ((got.pred != np.asarray(ref.pred)) <= undecided).all()
    ent = got.entropy_map.sum(axis=(1, 2)) / np.asarray(ref.entropy_map).sum(axis=(1, 2))
    assert (np.abs(ent - 1.0) < 0.15).all(), ent
    assert got.pred_samples.dtype == np.float32 and 0.0 < got.pred_samples.mean() < 1.0


@pytest.mark.parametrize("option", ["sequence_sampler", "soft_mask"])
def test_batched_run_predict_option_matches_jax(option, both_options):
    """run_predict with task.sequence_sampler and task.soft_mask at
    predict_batch_views = 3 (`both_options`) against the JAX package's
    batched run_predict at the same settings, view by view: the sequence
    sampler's contours (`_assert_contours_match_jax`) and the soft masks
    (`_assert_soft_masks_match_jax`). (One view per dispatch is held to
    this path in test_batched_views_match_one_view_per_dispatch, and the
    sequence samplers' coupling to JAX's in
    tests/test_torch_port_sequence.py.)"""
    check = _assert_contours_match_jax if option == "sequence_sampler" \
        else _assert_soft_masks_match_jax
    for g, r in zip(*both_options):
        check(g, r)


PATHS = {
    "gaussian": (DSNTAleatoric, {}),
    "skew": (DSNTSkew, {}),
    "sequence": (DSNTAleatoric, {"sequence_sampler": True}),
    "sequence_skew": (DSNTSkew, {"sequence_sampler": True}),
    "soft_mask": (DSNTAleatoric, {"soft_mask": True}),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_batched_views_match_one_view_per_dispatch(path, monkeypatch):
    """predict_batch_views = 3 over 4 views against one view per dispatch,
    with MC dropout live (T_e = 2, drop_block), on the Gaussian, skew,
    sequence and soft-mask paths: every view draws from its own generator
    in the same order either way, so only reassociation may differ. The
    JAX package's budgets (tests/test_parallel.py): mu within 1e-5, cov
    within 1e-4, contour samples within 1e-3 px, at most 8 pred pixels per
    view differing, entropy within 1e-3 on average; the rest of the outputs
    within 1e-5 of their scale. The skew umap runs at 10 levels (100 when
    served), which keeps its plain crossing selection on the CPU small."""
    monkeypatch.setattr(tpred, "skew_umap_groups", functools.partial(skew_umap_groups, levels=10))
    cls, task_cfg = PATHS[path]
    data = synthetic_camus_data(n_patients=7, size=SIZE, seed=2)
    task = cls(data_params=data.data_params, t_e=2, t_a=8, model_kwargs=SMALL)
    model = task.build_model(device="cpu", generator=torch.Generator().manual_seed(4))
    cfg = {"seed": 5, "task": task_cfg}
    one = tpred.run_predict(task, model, data, cfg, device="cpu")
    three = tpred.run_predict(task, model, data, {**cfg, "predict_batch_views": 3},
                              device="cpu")
    assert [r.id for r in one] == [r.id for r in three] and len(one) == 4
    for a, b in zip(one, three):
        np.testing.assert_allclose(a.mu, b.mu, rtol=0, atol=1e-5)
        np.testing.assert_allclose(a.cov, b.cov, rtol=0, atol=1e-4)
        assert np.abs(a.contour_samples - b.contour_samples).max() < 1e-3
        assert (a.pred != b.pred).sum() <= 8
        assert np.abs(a.entropy_map - b.entropy_map).mean() < 1e-3
        assert a.pred_samples.dtype == b.pred_samples.dtype
        for key in ("post_mu", "post_cov", "mode", "alpha", "uncertainty_map"):
            x, y = getattr(a, key), getattr(b, key)
            if x is None:
                assert y is None and "skew" not in path
                continue
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-5 * max(np.abs(x).max(), 1.0),
                                       err_msg=key)
        for group in ("point_uncertainty", "instant_uncertainty"):
            for key, x in getattr(a, group).items():
                np.testing.assert_allclose(x, getattr(b, group)[key], rtol=1e-5, atol=1e-6,
                                           err_msg=key)
