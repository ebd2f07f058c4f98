"""PyTorch port vs JAX package: closed-form 2x2 linear algebra, the
bivariate normal, the shape prior and the PSM sampler
(distributions/linalg.py, distributions/normal.py, sampler/prior.py,
sampler/psm.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu.distributions import linalg as jl
from contouring_uncertainty_tpu.distributions import normal as jn
from contouring_uncertainty_tpu.sampler import prior as jp
from contouring_uncertainty_tpu.sampler import psm as jpsm
from contouring_uncertainty_tpu.data.synthetic import make_arrays as j_make_arrays
from contouring_uncertainty_torch.distributions import linalg as tl
from contouring_uncertainty_torch.distributions import normal as tn
from contouring_uncertainty_torch.sampler import prior as tp
from contouring_uncertainty_torch.sampler import psm as tpsm

torch.set_num_threads(1)


def _spd(n, seed, scale=5.0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 2, 2)) * scale
    return (a @ a.transpose(0, 2, 1) + 0.1 * np.eye(2)).astype(np.float32)


@pytest.fixture(scope="module")
def train_contours():
    return j_make_arrays(24, k=21, size=64, seed=4)[2]


@pytest.mark.parametrize("fn", ["eigh2x2", "mat2_vec", "mat2_mat", "sym_matrix_pow",
                                "inv2x2", "det2x2", "chol2x2", "rotate_cov"])
def test_closed_form_2x2_matches_jax(fn):
    """Elementwise closed forms on both sides: equal to f32 rounding (a
    relative 1e-6, or 1e-6 of the matrices' scale where a result cancels)."""
    m = _spd(64, 1)
    other = _spd(64, 2)
    vec = np.random.default_rng(3).normal(size=(64, 2)).astype(np.float32)
    theta = np.random.default_rng(4).uniform(-3, 3, size=64).astype(np.float32)
    args = {
        "eigh2x2": (m,), "mat2_vec": (m, vec), "mat2_mat": (m, other),
        "sym_matrix_pow": (m, 0.5, 1e-6), "inv2x2": (m,), "det2x2": (m,),
        "chol2x2": (m,), "rotate_cov": (m, theta),
    }[fn]
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    targs = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    got, ref = getattr(tl, fn)(*targs), getattr(jl, fn)(*jargs)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6, atol=1e-6 * np.abs(r).max())


def test_bivariate_normal_logpdf_and_rvs():
    """logpdf to f32 rounding; rvs by sample mean and covariance (the RNG
    streams differ): 100k draws hold the mean within 5 standard errors and
    the covariance within 3% of its scale, as do JAX's draws."""
    cov = _spd(4, 5, scale=2.0)
    mu = np.random.default_rng(6).uniform(0, 64, size=(4, 2)).astype(np.float32)
    x = np.random.default_rng(7).uniform(0, 64, size=(4, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tn.logpdf(torch.as_tensor(x), torch.as_tensor(mu), torch.as_tensor(cov)).numpy(),
        np.asarray(jn.logpdf(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(cov))), rtol=1e-5)
    n = 100_000
    draws = {
        "torch": tn.rvs(torch.Generator().manual_seed(0), torch.as_tensor(mu),
                        torch.as_tensor(cov), shape=(n,)).numpy(),
        "jax": np.asarray(jn.rvs(jax.random.key(0), jnp.asarray(mu), jnp.asarray(cov), (n,))),
    }
    for name, d in draws.items():
        assert d.shape == (n, 4, 2)
        se = np.sqrt(np.diagonal(cov, axis1=1, axis2=2) / n)
        assert (np.abs(d.mean(0) - mu) < 5 * se).all(), name
        c = d - d.mean(0)
        emp = np.einsum("npi,npj->pij", c, c) / n
        assert (np.abs(emp - cov).max(axis=(1, 2)) < 0.03 * np.abs(cov).max(axis=(1, 2))).all(), name


def test_shape_prior_fit_save_load_match_jax(tmp_path, train_contours):
    """fit_shape_prior: the f64 statistics are identical (both are numpy);
    the PCA factor is held by sign-invariant quantities (Q Q^T = cov0, and
    F0 F0^T of cov_factor), because eigenvector signs differ. `.npz` files
    load both ways."""
    pj = jp.fit_shape_prior(train_contours)
    pt = tp.fit_shape_prior(train_contours)
    for name in ("mean_shape", "train_mean", "train_scale", "x_train_mean", "cov0"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)))
    scale = float(np.abs(np.asarray(pj.cov0)).max())
    q = pt.q.double()
    np.testing.assert_allclose((q @ q.T).numpy(), np.asarray(pj.cov0), atol=1e-5 * scale)
    fj = np.asarray(jp.cov_factor(pj), np.float64)
    ft = tp.cov_factor(pt).astype(np.float64)
    np.testing.assert_allclose(ft @ ft.T, fj @ fj.T, atol=1e-5 * scale)

    tp.save_prior(tmp_path / "t.npz", pt)
    back = jp.load_prior(tmp_path / "t.npz")
    jp.save_prior(tmp_path / "j.npz", pj)
    fwd = tp.load_prior(tmp_path / "j.npz")
    for name in tp.ShapePrior._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      getattr(pt, name).numpy())
        np.testing.assert_array_equal(getattr(fwd, name).numpy(),
                                      np.asarray(getattr(pj, name)))


def test_posterior_points_and_merge_match_jax(train_contours):
    """Given the same contour and prediction, every level's posterior
    (mu_c, cov_c) and the Gaussian-product fusion agree: the Sherman-Morrison
    operators are the same f64 host computation, and the f32 products
    differ only in summation order: 1e-3 px on mu_c and 1e-3 of cov_c's
    scale at the level sigmas. The fill step (sigma2 = 1e-3) is conditioned
    so that either side's f32 mean sits ~0.03 px from an f64 evaluation of
    the same formula, so there the two agree to 0.1 px."""
    prior_j = jp.fit_shape_prior(train_contours)
    prior_t = tp.fit_shape_prior(train_contours)
    sj = jpsm.PosteriorShapeModelSampler(prior_j)
    st = tpsm.PosteriorShapeModelSampler(prior_t, device="cpu")
    assert (st.initial_points, st.points_order) == (sj.initial_points, sj.points_order)
    assert tpsm.get_points_order(21) == jpsm.get_points_order(21)
    rng = np.random.default_rng(8)
    pred = (train_contours[0] + rng.normal(scale=2.0, size=(21, 2))).astype(np.float32)
    contour = (train_contours[1] + rng.normal(scale=1.0, size=(21, 2))).astype(np.float32)
    mu_t_j = jp.transform(prior_j, jnp.asarray(pred)).reshape(-1)
    d_j = jp.refit_d(prior_j, mu_t_j)
    mu_t_t = tp.transform(prior_t, torch.as_tensor(pred)).reshape(1, -1)
    d_t = tp.refit_d(prior_t, mu_t_t)
    for op_j, op_t in zip(sj._ops, st._ops):
        mu_j, cov_j = sj._posterior_points(jnp.asarray(contour), op_j, mu_t_j, d_j)
        mu_t, cov_t = st._posterior_points(torch.as_tensor(contour)[None, None],
                                           op_t, mu_t_t, d_t)
        np.testing.assert_allclose(mu_t[0, 0].numpy(), np.asarray(mu_j), atol=1e-3)
        cov_j = np.asarray(cov_j)
        assert np.abs(cov_t[0].numpy() - cov_j).max() < 1e-3 * np.abs(cov_j).max()
    mu_j, _ = sj._posterior_points(jnp.asarray(contour), sj._op_final, mu_t_j, d_j)
    mu_t, _ = st._posterior_points(torch.as_tensor(contour)[None, None],
                                   st._op_final, mu_t_t, d_t)
    np.testing.assert_allclose(mu_t[0, 0].numpy(), np.asarray(mu_j), atol=0.1)

    cov1, cov2 = _spd(21, 9), _spd(21, 10)
    m1, m2 = rng.normal(size=(2, 21, 2)).astype(np.float32)
    for a, b in zip(tpsm.merge_priors(*map(torch.as_tensor, (m1, cov1, m2, cov2))),
                    jpsm.merge_priors(*map(jnp.asarray, (m1, cov1, m2, cov2)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_psm_population_matches_jax(train_contours):
    """Sampled contours match in distribution (the RNG streams differ):
    from the same per-point Gaussians, 1000 samples per side give per-point
    means within 5 joint standard errors and per-point variances within 25%
    (sampling noise of a variance at n=1000 is ~4.5%)."""
    prior_j = jp.fit_shape_prior(train_contours)
    prior_t = tp.fit_shape_prior(train_contours)
    rng = np.random.default_rng(11)
    mu = (train_contours[2] + rng.normal(scale=1.0, size=(21, 2))).astype(np.float32)
    cov = np.tile((np.eye(2) * 4.0).astype(np.float32), (21, 1, 1))
    n = 1000
    sj = np.asarray(jpsm.PosteriorShapeModelSampler(prior_j).sample_batch(
        jax.random.key(1), jnp.asarray(mu)[None], jnp.asarray(cov)[None], n=n))[0]
    st = tpsm.PosteriorShapeModelSampler(prior_t, device="cpu").sample_batch(
        torch.Generator().manual_seed(1), torch.as_tensor(mu)[None],
        torch.as_tensor(cov)[None], n=n)[0].numpy()
    assert st.shape == sj.shape == (n, 21, 2)
    var_j, var_t = sj.var(0), st.var(0)
    se = np.sqrt((var_j + var_t) / n)
    assert (np.abs(st.mean(0) - sj.mean(0)) < 5 * se + 1e-3).all()
    np.testing.assert_allclose(var_t, var_j, rtol=0.25, atol=1e-3)
