"""PyTorch port vs JAX package: the serving slice as a whole
(utils/projection.py, utils/umap.py, predict.py).

The whole-slice test runs both AleatoricPredictors on the same image, the
same flax weights (converted for the port) and the same training contours.
The forward is deterministic (T_e = 1) so every prediction-derived output
can be compared tightly; the sampled outputs come from different RNG
streams and are compared in distribution. To give the untrained 4-stage
UNet meaningful contours, both sides add the same fixed logit map (sharp
1.5 px blobs at two synthetic LV contours' landmarks) to its heatmaps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu import predict as jpred
from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
from contouring_uncertainty_tpu.data.synthetic import make_arrays
from contouring_uncertainty_tpu.sampler import PosteriorShapeModelSampler as JSampler
from contouring_uncertainty_tpu.sampler import fit_shape_prior as j_fit
from contouring_uncertainty_tpu.tasks import DSNTAleatoric as JTask
from contouring_uncertainty_tpu.utils import projection as jproj
from contouring_uncertainty_tpu.utils import umap as jumap
from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch.convert import flax_to_torch_state
from contouring_uncertainty_torch.data.config import DataParams
from contouring_uncertainty_torch.data.synthetic import synthetic_camus_data
from contouring_uncertainty_torch.sampler import PosteriorShapeModelSampler, fit_shape_prior
from contouring_uncertainty_torch.tasks import DSNTAleatoric
from contouring_uncertainty_torch.utils import projection as tproj
from contouring_uncertainty_torch.utils import umap as tumap

torch.set_num_threads(1)

SIZE = 64
T_A = 128
SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3, drop_block=True)


def _mu_cov(seed, n=4):
    """Synthetic LV landmarks at 64^2 and random SPD per-point covariances."""
    mu = make_arrays(n, k=21, size=SIZE, seed=seed)[2]
    a = np.random.default_rng(seed).normal(size=(n, 21, 2, 2)) * 1.2
    cov = (a @ a.transpose(0, 1, 3, 2) + 0.5 * np.eye(2)).astype(np.float32)
    return mu, cov


def test_projection_matches_jax():
    """Projected sigmas, directions and the instant scalar: closed-form 2x2
    algebra on spline tangents, equal to f32 rounding (1e-5 relative; the
    tangents themselves agree to ~1e-6 at 64^2)."""
    mu, cov = _mu_cov(5)
    u_j, v_j = jax.vmap(jproj.projected_uncertainty)(jnp.asarray(mu), jnp.asarray(cov))
    u_t, v_t = tproj.projected_uncertainty(torch.as_tensor(mu), torch.as_tensor(cov))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)
    val_j = jax.vmap(jproj.projected_uncertainty_value)(jnp.asarray(mu), jnp.asarray(cov))
    val_t = tproj.projected_uncertainty_value(torch.as_tensor(mu), torch.as_tensor(cov))
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_j), rtol=1e-5)


def test_uncertainty_map_matches_jax():
    """uncertainty_map on identical mu/cov. Every pixel holds the largest
    pdf weight of the offset contours that round onto it. The weights agree
    to an f32 ulp (< 1e-6); the dense offset points agree to ~3e-5 px, so a
    point lying within that of a .5 rounding boundary can land one pixel
    over and change that pixel's value: at most 0.1% of the pixels may
    differ by more than 1e-6 (measured: 1 pixel in 16384)."""
    mu, cov = _mu_cov(5)
    ref = np.asarray(jax.vmap(lambda m, c: jumap.uncertainty_map(m, c, (SIZE, SIZE)))(
        jnp.asarray(mu), jnp.asarray(cov)))
    got = tumap.uncertainty_map(torch.as_tensor(mu), torch.as_tensor(cov), (SIZE, SIZE)).numpy()
    assert got.shape == ref.shape == (4, SIZE, SIZE)
    assert (ref > 0).mean() > 0.1
    assert (np.abs(got - ref) > 1e-6).mean() <= 1e-3


def test_predict_helpers_match_jax():
    """Fusion, population posterior, entropy and the point/instant scalars
    on the same inputs: elementwise f32 arithmetic and small reductions,
    equal to 1e-5 relative."""
    rng = np.random.default_rng(0)
    n, t_e, t_a, k = 2, 3, 5, 21
    mu_te = rng.normal(scale=3.0, size=(n, t_e, k, 2)).astype(np.float32) + 30.0
    cov_te = _mu_cov(6, n * t_e)[1].reshape(n, t_e, k, 2, 2)
    samples = (mu_te[:, :, None] + rng.normal(size=(n, t_e, t_a, k, 2))).astype(np.float32)
    occ = (rng.uniform(size=(n, t_e, t_a, 16, 16)) > 0.4).astype(np.float32)
    close = dict(rtol=1e-5, atol=1e-5)
    for a, b in zip(tpred.fuse_epistemic_aleatoric(torch.as_tensor(mu_te), torch.as_tensor(cov_te)),
                    jpred.fuse_epistemic_aleatoric(jnp.asarray(mu_te), jnp.asarray(cov_te))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **close)
    for a, b in zip(tpred.population_posterior(torch.as_tensor(samples)),
                    jpred.population_posterior(jnp.asarray(samples))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **close)
    ent_t = tpred.sample_entropy_map(torch.as_tensor(occ))
    ent_j = jpred.sample_entropy_map(jnp.asarray(occ))
    np.testing.assert_allclose(ent_t.numpy(), np.asarray(ent_j), **close)

    mu, cov = _mu_cov(7, n)
    post_cov = _mu_cov(8, n)[1]
    umap = rng.uniform(size=(n, 16, 16)).astype(np.float32)
    pred = (occ.mean(axis=(1, 2)) > 0.5).astype(np.int32)
    t_args = [torch.as_tensor(a) for a in (mu, cov, post_cov, umap)] + [ent_t, torch.as_tensor(pred)]
    j_args = [jnp.asarray(a) for a in (mu, cov, post_cov, umap)] + [ent_j, jnp.asarray(pred)]
    got = tpred.point_instant_uncertainty(*t_args)
    ref = jpred.point_instant_uncertainty(*j_args)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for key in r:
            np.testing.assert_allclose(g[key].numpy(), np.asarray(r[key]), err_msg=key, **close)


@pytest.fixture(scope="module")
def slice_outputs():
    """One view (ED, ES at 64^2) through both AleatoricPredictors."""
    imgs, _, contours = make_arrays(26, k=21, size=SIZE, seed=5)
    img, train, target = imgs[:2], contours[2:], contours[:2]
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    bias = (-((xx - target[..., 0, None, None]) ** 2 + (yy - target[..., 1, None, None]) ** 2)
            / (2 * 1.5 ** 2)).astype(np.float32)

    jtask = JTask(data_params=JDataParams(in_shape=(1, SIZE, SIZE), out_shape=(21, 2)),
                  t_e=1, t_a=T_A, model_kwargs=SMALL)
    junet = jtask.build_model()
    variables = jax.jit(junet.init)(jax.random.key(3), jnp.asarray(img))

    class JBiased:
        def apply(self, v, x, **kw):
            return {"out": junet.apply(v, x, **kw)["out"] + jnp.asarray(bias)}

    jp = jpred.AleatoricPredictor(jtask, JBiased(), JSampler(j_fit(train)))
    ref = jax.tree.map(np.asarray, jp(variables, jnp.asarray(img), jax.random.key(0)))

    task = DSNTAleatoric(data_params=DataParams(in_shape=(1, SIZE, SIZE), out_shape=(21, 2)),
                         t_e=1, t_a=T_A, model_kwargs=SMALL)
    unet = task.build_model(device="cpu")
    unet.load_state_dict(flax_to_torch_state(jax.tree.map(np.asarray, variables["params"])))

    class TBiased(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.unet = unet

        def forward(self, x, **kw):
            return {"out": self.unet(x, **kw)["out"] + torch.as_tensor(bias)}

    tp = tpred.AleatoricPredictor(task, TBiased(), PosteriorShapeModelSampler(
        fit_shape_prior(train), device="cpu"), device="cpu")
    got = tpred._to_numpy(tp(img, torch.Generator().manual_seed(0)))
    return got, ref


def test_slice_deterministic_outputs_match_jax(slice_outputs):
    """Outputs fixed by the forward: every output key, shape and dtype is
    the JAX one; mu within 1e-4 px and cov within 1e-3 of its scale (the
    two frameworks' f32 convolutions and moment sums round differently,
    measured 1e-5 px and 7e-5); the cov-derived point and instant scalars
    within 1e-3 relative; the uncertainty map as in
    test_uncertainty_map_matches_jax."""
    got, ref = slice_outputs
    assert got.keys() == ref.keys()
    for key, r in ref.items():
        if isinstance(r, np.ndarray):
            assert got[key].shape == r.shape and got[key].dtype == r.dtype, key
    assert got["alpha"] is None and ref["alpha"] is None
    np.testing.assert_allclose(got["mu"], ref["mu"], atol=1e-4)
    np.testing.assert_array_equal(got["mode"], got["mu"])
    assert np.abs(got["cov"] - ref["cov"]).max() < 1e-3 * np.abs(ref["cov"]).max()
    for key in ("cov_xx", "cov_yy", "cov_det", "cov_eigval_sum"):
        np.testing.assert_allclose(got["point_uncertainty"][key],
                                   ref["point_uncertainty"][key], rtol=1e-3, err_msg=key)
    for key in ("cov_det_mean", "cov_eigenvalue_mean", "cov_projection"):
        np.testing.assert_allclose(got["instant_uncertainty"][key],
                                   ref["instant_uncertainty"][key], rtol=1e-3, err_msg=key)
    umap_j, umap_t = ref["uncertainty_map"], got["uncertainty_map"]
    assert (umap_j > 0).mean() > 0.1
    assert (np.abs(umap_t - umap_j) > 1e-6).mean() <= 1e-3


def test_slice_sampled_outputs_match_jax_in_distribution(slice_outputs):
    """Outputs of the sample population (T_a = 128 contours per frame, other
    RNG streams): post_mu within 5 joint standard errors per coordinate;
    each frame's summed posterior variance within 25% (the PSM population
    spreads over a few shape modes, so its variance estimate at n = 128
    carries ~12% noise per side); the per-pixel occupancy of the sample
    masks within 5 binomial standard errors; the majority-vote prediction
    within 5% of the mask area and the summed entropy within 15% (both
    measured at 2-7%); sample masks hold {0, label} as uint8."""
    got, ref = slice_outputs
    var_j = np.einsum("nkii->nki", ref["post_cov"])
    var_t = np.einsum("nkii->nki", got["post_cov"])
    assert (np.abs(got["post_mu"] - ref["post_mu"]) < 5 * np.sqrt((var_j + var_t) / T_A)).all()
    ratio = var_t.sum(axis=(1, 2)) / var_j.sum(axis=(1, 2))
    assert (np.abs(ratio - 1.0) < 0.25).all(), ratio

    assert set(np.unique(got["pred_samples"])) == {0, 1}
    occ_j = ref["pred_samples"].mean(axis=(1, 2), dtype=np.float64)
    occ_t = got["pred_samples"].mean(axis=(1, 2), dtype=np.float64)
    p = (occ_j + occ_t) / 2
    se = np.sqrt(np.maximum(p * (1 - p), 1.0 / T_A) * 2 / T_A)
    assert (np.abs(occ_t - occ_j) <= 5 * se).all()

    area = ref["pred"].sum(axis=(1, 2))
    assert (area > 300).all()
    assert ((got["pred"] != ref["pred"]).sum(axis=(1, 2)) <= 0.05 * area).all()
    ent = got["entropy_map"].sum(axis=(1, 2)) / ref["entropy_map"].sum(axis=(1, 2))
    assert (np.abs(ent - 1.0) < 0.15).all(), ent


def test_run_predict_on_synthetic_views(tmp_path):
    """run_predict end to end on the CPU: one BatchResult per test view with
    the JAX package's shapes, T_e-major MC dropout live (T_e = 2), the prior
    fitted once and cached at task.psm_path, then loaded back unchanged."""
    data = synthetic_camus_data(n_patients=5, size=SIZE, seed=1)
    task = DSNTAleatoric(data_params=data.data_params, t_e=2, t_a=4, model_kwargs=SMALL)
    model = task.build_model(device="cpu", generator=torch.Generator().manual_seed(0))
    cfg = {"seed": 3, "task": {"psm_path": str(tmp_path / "prior.npz")}}
    results = tpred.run_predict(task, model, data, cfg, device="cpu")
    views = list(data.predict_views("test"))
    assert [r.id for r in results] == [v["id"] for v in views]
    n, k = 2, 21
    shapes = {"mu": (n, k, 2), "post_cov": (n, k, 2, 2), "contour_samples": (n, 2, 4, k, 2),
              "pred_samples": (n, 2, 4, SIZE, SIZE), "pred": (n, SIZE, SIZE),
              "entropy_map": (n, SIZE, SIZE)}
    for res, view in zip(results, views):
        for key, shape in shapes.items():
            assert getattr(res, key).shape == shape, key
            assert np.isfinite(getattr(res, key).astype(np.float64)).all(), key
        assert res.pred_samples.dtype == np.uint8 and res.mu.dtype == np.float32
        assert all(v.shape == (n,) for v in res.instant_uncertainty.values())
        np.testing.assert_array_equal(res.img, view["img"])
        np.testing.assert_array_equal(res.contour, view["contour"])
    assert (tmp_path / "prior.npz").exists()
    prior = tpred.get_or_fit_prior(data, str(tmp_path / "prior.npz"))
    fitted = fit_shape_prior(data.train_arrays("train")["contour"])
    for a, b in zip(prior, fitted):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    again = tpred.run_predict(task, model, data, cfg, device="cpu")
    np.testing.assert_array_equal(again[0].contour_samples, results[0].contour_samples)


def test_cached_prior_is_keyed_by_the_training_contours(tmp_path, capsys):
    """The prior cached at task.psm_path holds the digest of the contours it
    was fit on: a run on other data (another seed, another image size) refits
    and overwrites it instead of loading the old prior, and an unchanged run
    loads it. A prior written by the JAX package (no digest) is loaded when
    it fits the data and refused when its dimension or its image scale does
    not."""
    from contouring_uncertainty_tpu.sampler.prior import save_prior as j_save

    path = str(tmp_path / "prior.npz")
    small = synthetic_camus_data(n_patients=5, size=SIZE, seed=1)
    other = synthetic_camus_data(n_patients=5, size=SIZE, seed=2)
    larger = synthetic_camus_data(n_patients=5, size=4 * SIZE, seed=1)
    tpred.get_or_fit_prior(small, path)
    capsys.readouterr()
    for data in (other, larger, small):
        prior = tpred.get_or_fit_prior(data, path)
        assert "refitting" in capsys.readouterr().out
        for a, b in zip(prior, fit_shape_prior(data.train_arrays("train")["contour"])):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    tpred.get_or_fit_prior(small, path)
    assert "refitting" not in capsys.readouterr().out

    contours = small.train_arrays("train")["contour"]
    j_save(path, j_fit(contours))
    prior = tpred.get_or_fit_prior(small, path)
    # The JAX fit of the same contours: its means and covariance are the
    # same f64 fit rounded to f32 (its factor q may differ in eigenvector
    # signs).
    fitted = fit_shape_prior(contours)
    for key in ("mean_shape", "train_mean", "train_scale", "x_train_mean", "cov0"):
        torch.testing.assert_close(getattr(prior, key), getattr(fitted, key),
                                   rtol=1e-6, atol=1e-4)
    with pytest.raises(ValueError, match="mean contour"):
        tpred.get_or_fit_prior(larger, path)
    j_save(path, j_fit(contours[:, :10]))
    with pytest.raises(ValueError, match="dimension 20"):
        tpred.get_or_fit_prior(small, path)
