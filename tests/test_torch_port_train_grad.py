"""PyTorch port vs JAX package: the gradients of the DSNT moment ops
(ops/dsnt_kernel.py RowMoments / ColMoments, ops/dsnt.py heads and losses).

The JAX side is `jax.grad` through the custom VJPs `dsnt_raw_moments` and
`dsnt_raw_moments_cols` (pallas_dsnt.py:241-317; on the CPU their forward
is the XLA reference and their backward the XLA adjoint). Inputs are made
with numpy from a seed and handed to both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu.ops import dsnt as jd
from contouring_uncertainty_tpu.ops import pallas_dsnt
from contouring_uncertainty_torch.ops import dsnt as td
from contouring_uncertainty_torch.ops import dsnt_kernel

torch.set_num_threads(1)


def _logits(rows, height, width, seed, sharp=False):
    rng = np.random.default_rng(seed)
    if not sharp:
        return rng.normal(size=(rows, height * width)).astype(np.float32)
    yy, xx = np.mgrid[0:height, 0:width]
    cx = rng.uniform(0.2 * width, 0.8 * width, rows)[:, None, None]
    cy = rng.uniform(0.2 * height, 0.8 * height, rows)[:, None, None]
    s = rng.uniform(1.5, 6.0, rows)[:, None, None]
    x = -((xx - cx) ** 2 + (yy - cy) ** 2) / (2.0 * s * s)
    return x.reshape(rows, -1).astype(np.float32)


@pytest.mark.parametrize("layout", ["rows", "cols"])
@pytest.mark.parametrize("sharp", [False, True], ids=["random", "sharp"])
def test_moment_gradients_match_jax_custom_vjp(layout, sharp):
    """f32 gradients of sum(moments * g) against jax.grad of the JAX custom
    VJP: within 1e-5 of the largest gradient plus 1e-5 relative (both
    recompute the softmax in f32; JAX contracts the basis with a HIGHEST
    matmul, the port sums the separable basis)."""
    h, w = 48, 64
    x = _logits(6, h, w, seed=1, sharp=sharp)
    g = np.random.default_rng(2).normal(size=(6, 8)).astype(np.float32)
    if layout == "rows":
        jfn, tfn, xin = pallas_dsnt.dsnt_raw_moments, dsnt_kernel.dsnt_raw_moments, x
    else:
        jfn, tfn, xin = pallas_dsnt.dsnt_raw_moments_cols, dsnt_kernel.dsnt_raw_moments_cols, x.T
    ref = np.asarray(jax.grad(lambda a: jnp.sum(jfn(a, h, w) * g))(jnp.asarray(xin)))
    t = torch.tensor(xin, requires_grad=True)
    out = tfn(t, h, w)
    assert out.grad_fn is not None
    out.backward(torch.as_tensor(g))
    got = t.grad.numpy()
    assert got.shape == ref.shape == xin.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_moment_functions_pass_gradcheck_in_f64(layout):
    """torch.autograd.gradcheck in f64 (forward and adjoint accumulate in
    f64 for f64 logits), non-square images."""
    rng = np.random.default_rng(3)
    h, w = 6, 10
    if layout == "rows":
        x = torch.tensor(rng.normal(size=(4, h * w)), requires_grad=True)
        fn = dsnt_kernel.dsnt_raw_moments
    else:
        x = torch.tensor(rng.normal(size=(h * w, 4)), requires_grad=True)
        fn = dsnt_kernel.dsnt_raw_moments_cols
    assert torch.autograd.gradcheck(lambda a: fn(a, h, w), (x,))


def _kernel_launchers_as_ctypes(monkeypatch):
    """Route CPU tensors as the card's tensors are routed, with each kernel
    launcher replaced by its plain version computed as the ctypes kernels
    write their output: into a tensor outside autograd's graph."""
    launches = {"rows": 0, "cols": 0}

    def rows(x2d, height, width, bands=None):
        launches["rows"] += 1
        with torch.no_grad():
            return dsnt_kernel.raw_moments_plain(x2d, height, width)

    def cols(flat_t, height, width):
        launches["cols"] += 1
        with torch.no_grad():
            return dsnt_kernel.raw_moments_plain(flat_t.t(), height, width)

    monkeypatch.setattr(dsnt_kernel, "_on_card", lambda x: True)
    monkeypatch.setattr(dsnt_kernel, "raw_moments_cuda", rows)
    monkeypatch.setattr(dsnt_kernel, "raw_moments_cols_cuda", cols)
    return launches


@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_kernel_route_carries_gradients(monkeypatch, layout):
    """The fault this slice repairs: a kernel's output, written through
    ctypes, has no grad_fn, so before the autograd Functions no gradient
    reached the logits on the card. With the launchers standing in for the
    kernels (same route, no graph), the moments' dispatch alone still has no
    grad_fn, and the public ops carry the exact gradient of the plain
    version through the Function, with one launch each."""
    launches = _kernel_launchers_as_ctypes(monkeypatch)
    h, w = 16, 24
    x = torch.tensor(_logits(5, h, w, seed=4), requires_grad=True)
    g = torch.as_tensor(np.random.default_rng(5).normal(size=(5, 8)).astype(np.float32))
    x_route = x if layout == "rows" else x.t().contiguous().t()
    assert dsnt_kernel.moment_route(x_route) == layout
    assert dsnt_kernel._raw_moments(x_route, h, w).grad_fn is None
    launches.update(rows=0, cols=0)
    if layout == "rows":
        out = dsnt_kernel.dsnt_raw_moments(x, h, w)
    else:
        xt = x.detach().t().contiguous().requires_grad_()
        out = dsnt_kernel.dsnt_raw_moments_cols(xt, h, w)
    assert launches == {"rows": int(layout == "rows"), "cols": int(layout == "cols")}
    assert out.grad_fn is not None
    out.backward(g)
    got = x.grad if layout == "rows" else xt.grad.t()
    xd = x.detach().double().requires_grad_()
    dsnt_kernel.raw_moments_plain(xd, h, w).backward(g.double())
    np.testing.assert_allclose(got.numpy(), xd.grad.numpy(), rtol=1e-5,
                               atol=1e-6 * float(xd.grad.abs().max()))


def test_serving_under_inference_mode_is_unchanged(monkeypatch):
    """Under torch.inference_mode the head gives the same (mu, Sigma) as the
    plain moments do, with one launch per call and no graph; grad mode
    gives the same values."""
    launches = _kernel_launchers_as_ctypes(monkeypatch)
    x = torch.as_tensor(_logits(2 * 21, 32, 32, seed=6, sharp=True).reshape(2, 21, 32, 32))
    with torch.inference_mode():
        mu, sigma = td.logits_to_pixel_gaussians(x)
    assert launches["rows"] == 1 and mu.grad_fn is None
    raw = dsnt_kernel.raw_moments_plain(x.reshape(-1, 32 * 32), 32, 32)[:, :6]
    mu_p, sigma_p = td.raw6_to_pixel_gaussians(raw.reshape(2, 21, 6), 32, 32)
    torch.testing.assert_close(mu, mu_p, rtol=0, atol=0)
    torch.testing.assert_close(sigma, sigma_p, rtol=0, atol=0)
    mu_g, sigma_g = td.logits_to_pixel_gaussians(x.clone().requires_grad_())
    torch.testing.assert_close(mu_g.detach(), mu, rtol=0, atol=0)
    torch.testing.assert_close(sigma_g.detach(), sigma, rtol=0, atol=0)


def test_head_and_loss_gradients_match_jax():
    """d(mean NLL + mean Euclidean error)/dlogits through
    logits_to_pixel_gaussians, gaussian_nll and euclidean_error against
    jax.grad of the JAX head (its f32 separable branch on the CPU, plain
    XLA autodiff): within 2e-4 of the largest gradient, and the port within
    2e-5 of the same computation in f64. The log-det and Mahalanobis terms
    amplify f32 rounding of E[x^2] - E[x]^2: measured here, JAX's autodiff
    of the separable sums is 1.2e-4 from f64 and the port's adjoint 6e-6."""
    h = w = 32
    x = _logits(2 * 21, h, w, seed=7, sharp=True).reshape(2, 21, h, w)
    y = np.random.default_rng(8).uniform(8, 24, size=(2, 21, 2)).astype(np.float32)

    def jloss(a):
        mu, sigma = jd.logits_to_pixel_gaussians(a)
        nll, _, _ = jd.gaussian_nll(mu, sigma, jnp.asarray(y), 0.5, 2.0)
        return nll.mean() + jd.euclidean_error(mu, jnp.asarray(y)).mean()

    def tgrad(dtype):
        t = torch.tensor(x, dtype=dtype, requires_grad=True)
        yt = torch.as_tensor(y, dtype=dtype)
        mu, sigma = td.logits_to_pixel_gaussians(t)
        nll, _, _ = td.gaussian_nll(mu, sigma, yt, 0.5, 2.0)
        (nll.mean() + td.euclidean_error(mu, yt).mean()).backward()
        return t.grad.numpy()

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    got, f64 = tgrad(torch.float32), tgrad(torch.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4 * np.abs(ref).max())
    np.testing.assert_allclose(got, f64, rtol=0, atol=2e-5 * np.abs(f64).max())
