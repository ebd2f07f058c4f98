"""PyTorch port vs JAX package: the bivariate skew-normal
(distributions/skew_normal.py, linalg.py `cov2corr` and `rotate_alpha`).

Deterministic functions take the same numpy inputs in both packages. The
samplers are transforms of standard draws: the test makes JAX's own draws
(`jax.random.split`, `normal`, `uniform`, as the JAX samplers make them)
and passes them to the port's transform, which must give the JAX sampler's
samples. The samplers as they run (the port's draws from a
`torch.Generator`) are compared with JAX's in distribution, by mean and
covariance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu.distributions import bsn as jbsn
from contouring_uncertainty_tpu.distributions import linalg as jlinalg
from contouring_uncertainty_torch.distributions import bsn
from contouring_uncertainty_torch.distributions import linalg

torch.set_num_threads(1)

B = 64


def _inputs(seed=0, b=B):
    """Means around an LV-sized 64^2 image, SPD covariances of 0.3-10 px^2
    with correlation, skews of either sign up to |alpha| ~ 6, and points
    within a few sigma of the means."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(10, 50, size=(b, 2))
    a = rng.normal(size=(b, 2, 2)) * 1.5
    cov = a @ a.transpose(0, 2, 1) + 0.3 * np.eye(2)
    alpha = rng.normal(scale=2.5, size=(b, 2))
    x = mu + rng.normal(scale=2.0, size=(b, 2))
    return {k: v.astype(np.float32) for k, v in
            dict(x=x, mu=mu, cov=cov, alpha=alpha).items()}


def _both(fn_t, fn_j, *arrays):
    got = fn_t(*(torch.as_tensor(a) for a in arrays))
    ref = fn_j(*(jnp.asarray(a) for a in arrays))
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


def test_linalg_helpers_match_jax():
    """cov2corr and rotate_alpha: elementwise f32 arithmetic, within 1e-6."""
    d = _inputs(1)
    theta = np.random.default_rng(1).uniform(-np.pi, np.pi, B).astype(np.float32)
    for g, r in zip(*_both(linalg.cov2corr, jlinalg.cov2corr, d["cov"])):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)
    for g, r in zip(*_both(linalg.rotate_alpha, jlinalg.rotate_alpha, d["alpha"], theta)):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)


DENSITY = {
    "logpdf": (lambda m: m.logpdf, ("x", "mu", "cov", "alpha")),
    "mode": (lambda m: m.mode, ("mu", "cov", "alpha")),
    "marginal": (lambda m: lambda mu, cov, alpha: m.marginal(mu, cov, alpha, axis=0,
                                                            angle=0.7), ("mu", "cov", "alpha")),
    "marginal_y": (lambda m: lambda mu, cov, alpha: m.marginal(mu, cov, alpha, axis=1,
                                                              angle=-2.1), ("mu", "cov", "alpha")),
    "skewness": (lambda m: m.skewness, ("alpha",)),
    "m0": (lambda m: m.m0, ("alpha",)),
}


@pytest.mark.parametrize("name", list(DENSITY))
def test_density_functions_match_jax(name):
    """logpdf, the analytic mode, the rotated marginals (the y flip of
    alpha included) and the univariate helpers on the same inputs: within
    rtol 1e-5 (atol 1e-5 for values near 0: the closed-form 2x2 powers and
    log_ndtr round differently in the last bits)."""
    pick, keys = DENSITY[name]
    d = _inputs(2)
    got, ref = _both(pick(bsn), pick(jbsn), *(d[k] for k in keys))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=name)


def _whitened_skew_f64(d):
    """alpha^T Sigma^{-1/2} (x - mu) in f64."""
    vals, vecs = np.linalg.eigh(d["cov"].astype(np.float64))
    inv_sqrt = vecs @ (vecs.transpose(0, 2, 1) / np.sqrt(vals)[..., None])
    white = np.einsum("bij,bj->bi", inv_sqrt, (d["x"] - d["mu"]).astype(np.float64))
    return (d["alpha"] * white).sum(-1)


def test_nll_matches_jax():
    """The training NLL 0.5 log|S| + 0.5 maha - term3 and its terms, with
    term3 = log(Phi(z) + 1e-7), Phi(z) = (1 + erf(z / sqrt 2)) / 2 (the
    reference's clipped form). log|S|, the Mahalanobis term, and term3 and
    the loss where Phi(z) >= 1e-3 (z >= -3.09): within rtol 1e-5. Below,
    1 + erf cancels in f32 in both packages, and JAX's erf (XLA's f32
    approximation, which stops at 1 - 2e-7) and torch's differ by up to 4%
    of term3 (z = -9.5: -15.48 and -16.12, log 1e-7 being the floor): there
    each package's Phi(z) + 1e-7 = exp(term3) lies within 3e-7 (the f32
    rounding of erf next to -1, and XLA's approximation error) of the f64
    value, and the loss is the same terms' sum."""
    from scipy.special import ndtr

    d = _inputs(2)
    got, ref = _both(bsn.nll, jbsn.nll, *(d[k] for k in ("x", "mu", "cov", "alpha")))
    z = _whitened_skew_f64(d)
    body = ndtr(z) >= 1e-3
    assert 0 < body.sum() < B  # both regimes are held
    for g, r in zip(got[1:3], ref[1:3]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
    for g, r in zip((got[0], got[3]), (ref[0], ref[3])):
        np.testing.assert_allclose(g[body], r[body], rtol=1e-5, atol=1e-5)
    exact = ndtr(z[~body]) + 1e-7
    for loss, logdet, maha, term3 in (got, ref):
        assert np.abs(np.exp(term3[~body].astype(np.float64)) - exact).max() <= 3e-7
        np.testing.assert_allclose(loss, 0.5 * logdet + 0.5 * maha - term3, rtol=1e-6)


SHAPE = (3,)


def _jax_sign_flip_draws(key, batch):
    """JAX's draws for `rvs` / `rvs_consistent` (`_rvs_from_delta`)."""
    k0, k1 = jax.random.split(key)
    return (jax.random.normal(k0, (*SHAPE, *batch), jnp.float32),
            jax.random.normal(k1, (*SHAPE, *batch, 2), jnp.float32))


def _jax_product_draws(key, batch):
    """JAX's draws for `rvs_product`."""
    kv, kz = jax.random.split(key)
    return (jax.random.uniform(kv, (*SHAPE, *batch), jnp.float32),
            jax.random.normal(kz, (*SHAPE, *batch, 2), jnp.float32))


def _product_args(d):
    """A merged Gaussian (mu_f, cov_f), a whitened skew direction and the
    skew factor's location near it, as the skew PSM sampler forms them."""
    w = np.array(jlinalg.mat2_vec(jlinalg.sym_matrix_pow(jnp.asarray(d["cov"]), -0.5),
                                    jnp.asarray(d["alpha"])))
    return d["mu"], 0.5 * d["cov"], w, d["x"]


TRANSFORMS = {
    "rvs": (_jax_sign_flip_draws, bsn.rvs_from_draws, jbsn.rvs,
            lambda d: (d["mu"], d["cov"], d["alpha"])),
    "rvs_consistent": (_jax_sign_flip_draws, bsn.rvs_consistent_from_draws,
                       jbsn.rvs_consistent, lambda d: (d["mu"], d["cov"], d["alpha"])),
    "rvs_product": (_jax_product_draws, bsn.rvs_product_from_draws, jbsn.rvs_product,
                    _product_args),
}


@pytest.fixture(scope="module")
def jax_samples():
    """Each JAX sampler's samples from one key, beside the standard draws
    it makes from that key, all from one compiled function."""
    args = {name: tuple(jnp.asarray(a) for a in spec[3](_inputs(3)))
            for name, spec in TRANSFORMS.items()}

    def run(key, args):
        return {name: (spec[2](key, *args[name], shape=SHAPE), spec[0](key, (B,)))
                for name, spec in TRANSFORMS.items()}

    out = jax.jit(run)(jax.random.key(11), args)
    return {name: (np.asarray(ref), [np.array(d) for d in draws], args[name])
            for name, (ref, draws) in out.items()}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_sampler_transforms_match_jax_on_the_same_draws(name, jax_samples):
    """Each port sampler's transform, fed the standard draws the JAX
    sampler makes from its key, gives the JAX sampler's samples within
    1e-5 of their scale (the samples are tens of px; the transforms'
    2x2 factors, ndtri and log_ndtr round differently in the last bits)."""
    transform = TRANSFORMS[name][1]
    ref, draws, args = jax_samples[name]
    got = transform(*(torch.as_tensor(np.array(a)) for a in (*draws, *args))).numpy()
    assert got.shape == ref.shape == (*SHAPE, B, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def moment_z_scores(got, ref):
    """Mean and covariance entries of two sample sets (..., n, 2) against
    each other, in units of the standard error of their difference: means
    by the sample variances, covariance entries by the variance of the
    centred products. Returns the z scores, flattened: per leading index
    the x and y means, then xx, yy and xy."""
    n_a, n_b = got.shape[-2], ref.shape[-2]
    ma, mb = got.mean(-2), ref.mean(-2)
    z = [np.abs(ma - mb) / np.sqrt(got.var(-2, ddof=1) / n_a + ref.var(-2, ddof=1) / n_b)]
    ca, cb = got - ma[..., None, :], ref - mb[..., None, :]
    for i, j in ((0, 0), (1, 1), (0, 1)):
        pa, pb = ca[..., i] * ca[..., j], cb[..., i] * cb[..., j]
        se = np.sqrt(pa.var(-1, ddof=1) / n_a + pb.var(-1, ddof=1) / n_b)
        z.append((np.abs(pa.mean(-1) - pb.mean(-1)) / se)[..., None])
    return np.concatenate(z, axis=-1).ravel()


def test_rvs_product_moments_match_jax():
    """The extended skew-normal draw as it runs: 8 configurations x 10,000
    samples from the port's generator and from JAX's key. Each of the 8 x 5
    mean and covariance comparisons lies within 3 standard errors of the
    difference, except at most 2 (each exceeds 3 SE with probability 0.27%
    when the laws are equal), and none beyond 4.5."""
    d = {k: v[:8] for k, v in _inputs(4).items()}
    args = _product_args(d)
    n = 10_000
    sampler = jax.jit(jbsn.rvs_product, static_argnames="shape")
    ref = np.asarray(sampler(jax.random.key(5), *(jnp.asarray(a) for a in args), shape=(n,)))
    got = bsn.rvs_product(torch.Generator().manual_seed(5),
                          *(torch.as_tensor(a) for a in args), shape=(n,)).numpy()
    z = moment_z_scores(got.transpose(1, 0, 2).astype(np.float64),
                        ref.transpose(1, 0, 2).astype(np.float64))
    assert z.size == 40
    assert (z > 3.0).sum() <= 2 and z.max() < 4.5, np.sort(z)[-5:]
