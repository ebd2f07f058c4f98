"""PyTorch port vs JAX package: splines, the crossing selection's plain
version and the scanline fill (ops/spline.py, ops/select_kernel.py,
ops/rasterize.py).

The JAX Pallas selection kernel runs in interpret mode, as the JAX
package's own tests run it on the CPU; the JAX fills take its exact top-k
path.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu.ops import rasterize as jr
from contouring_uncertainty_tpu.ops import spline as js
from contouring_uncertainty_tpu.ops.pallas_select import min_k_crossings as j_min_k
from contouring_uncertainty_torch.ops import rasterize as tr
from contouring_uncertainty_torch.ops import select_kernel
from contouring_uncertainty_torch.ops import spline as ts

torch.set_num_threads(1)


def _lv_like_contour(k=21, jitter=0.0, seed=0):
    """The LV-like shape family of tests/test_spline_rasterize.py."""
    t = np.linspace(0, np.pi, k)
    pts = np.stack(
        [128 + 60 * np.cos(t) + 5 * np.sin(3 * t), 200 - 140 * np.sin(t * 0.5)], -1
    )
    if jitter:
        pts += np.random.default_rng(seed).normal(scale=jitter, size=pts.shape)
    return pts.astype(np.float32)


def _circle(r=50.0):
    t = np.linspace(0, 2 * np.pi, 21, endpoint=False)
    return np.stack([128 + r * np.cos(t), 128 + r * np.sin(t)], -1).astype(np.float32)


@pytest.fixture(scope="module")
def contours():
    """LV-like shapes (plain and jittered), a circle and 16 zigzag contours."""
    shapes = [_lv_like_contour()] + [_lv_like_contour(jitter=3.0, seed=s) for s in range(4)]
    shapes.append(_circle())
    return np.concatenate([np.stack(shapes), tr.zigzag_contours(16, seed=0)])


@pytest.fixture(scope="module")
def dense_jax(contours):
    """The JAX package's dense splines (n=1024): the same polygons go to
    both fills, so the fill comparison is exact by construction of input."""
    return np.asarray(jax.vmap(lambda p: js.contour_spline(p, n=1024))(jnp.asarray(contours)))


def test_contour_spline_and_tangents_match_jax(contours, dense_jax):
    """Chord-length not-a-knot splines and unit tangents against JAX, and
    the `close` endpoint.

    Tolerance 2e-4 px, set by f32 itself: the dense points move by about
    (contour length) x (knot rounding), and a 1-ulp change of a chord-length
    knot (1.2e-7; XLA's CPU compiler fuses dx*dx + dy*dy into one rounding,
    PyTorch rounds twice) is ~1e-4 px on these 300-800 px contours. Both
    sides sit ~1e-4 px from an f64 evaluation of the same algorithm, which
    the port must also stay within. The unit tangents move by the same
    knot rounding over the ~20-60 px segments: 1e-4."""
    got = ts.contour_spline(torch.as_tensor(contours), n=1024).numpy()
    assert got.shape == dense_jax.shape == (22, 1024, 2)
    np.testing.assert_allclose(got, dense_jax, atol=2e-4, rtol=0)
    f64 = ts.contour_spline(torch.as_tensor(contours).double(), n=1024).numpy()
    assert np.abs(got - f64).max() < 2e-4
    assert np.abs(dense_jax - f64).max() < 2e-4
    closed = ts.contour_spline(torch.as_tensor(contours[:2]), n=100, close=True)
    assert closed.shape == (2, 101, 2)
    torch.testing.assert_close(closed[:, -1], closed[:, 0], rtol=0, atol=0)
    tan_j = np.asarray(jax.vmap(js.contour_tangents)(jnp.asarray(contours)))
    np.testing.assert_allclose(ts.contour_tangents(torch.as_tensor(contours)).numpy(),
                               tan_j, atol=1e-4)
    # jnp.linspace's formula; XLA's CPU code divides by the step count as a
    # reciprocal multiply, so values differ by up to one ulp of the endpoints.
    for lo, hi, n in ((0.0, 1.0, 1024), (-2.0, 2.0, 100)):
        np.testing.assert_allclose(ts.linspace(lo, hi, n).numpy(),
                                   np.asarray(jnp.linspace(lo, hi, n)),
                                   rtol=0, atol=np.spacing(np.float32(hi)))


def test_selection_plain_matches_jax_pallas_kernel_interpret(dense_jax):
    """The selection's plain version (the port's reference for the CUDA
    kernel) against the JAX Pallas kernel run in interpret mode: the same
    crossings in the same +inf-padded slots, each within one f32 ulp.
    XLA's CPU compiler fuses x0 + tt*(x1 - x0) into one fused multiply-add;
    the port rounds the product and the sum separately (as the CUDA kernel,
    built with --fmad=false, does bit for bit). An FMA emulation in f64
    reproduces the JAX values exactly, so the ulp is that rounding only."""
    sel = jax.jit(jax.vmap(lambda p: j_min_k(p, 256, 16, interpret=True)))
    ref = np.asarray(sel(jnp.asarray(dense_jax)))
    before = select_kernel.launches
    got = select_kernel.min_k_crossings(torch.as_tensor(dense_jax.copy()), 256).numpy()
    assert select_kernel.launches == before  # CPU tensors never launch
    assert got.shape == ref.shape == (22, 256, 16)
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_max_ulp(got[finite], ref[finite], maxulp=1)
    assert finite.sum() > 1000
    with pytest.raises(RuntimeError, match="no crossing-selection kernel"):
        select_kernel.min_k_crossings(torch.as_tensor(dense_jax.copy()).to("meta"), 256)


@pytest.mark.parametrize("case", ["integer_rows", "horizontal", "outside", "many_crossings"])
def test_selection_plain_matches_jax_pallas_kernel_on_edge_cases(case):
    """The inputs that make the CUDA kernel's edge enumeration hard (the
    same ones chip_smoke.py holds the kernel to on the card), at H = 64 and
    E = 256: the plain version against the JAX Pallas kernel in interpret
    mode, the same crossings in the same slots, each within the one rounding
    of the FMA of the test above: one ulp of the product tt * (x1 - x0),
    taken as the ulp of the polygon's largest |x| (crossings near x = 0
    cancel, so a bound in ulps of the result would not hold); and the
    even-odd fills pixel-exact against the JAX exact path run op by op. Under `jit` XLA fuses the crossing's
    multiply-add, and on these integer vertices a crossing at exactly
    x = 7.0 comes out one ulp above it and flips pixel 7; op by op, JAX
    rounds the product and the sum separately, as the port does."""
    size = tr.EDGE_CASE_SIZE
    dense = tr.selection_edge_cases()[case]
    assert dense.shape[1:] == (256, 2)
    sel = jax.jit(jax.vmap(lambda p: j_min_k(p, size, 16, interpret=True)))
    ref = np.asarray(sel(jnp.asarray(dense)))
    got = select_kernel.min_k_crossings(torch.as_tensor(dense), size).numpy()
    assert got.shape == ref.shape == (len(dense), size, 16)
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    ulp = np.broadcast_to(np.spacing(np.abs(dense[..., 0]).max(axis=1))[:, None, None], got.shape)
    assert (np.abs(got[finite] - ref[finite]) <= ulp[finite]).all()
    assert finite.sum() > 0
    per_row = np.isfinite(select_kernel.crossing_candidates(torch.as_tensor(dense), size)
                          .numpy()).sum(-1)
    ties = ((got[..., 1:] == got[..., :-1]) & np.isfinite(got[..., 1:])).sum()
    if case == "integer_rows":
        assert ties > 0
    if case == "many_crossings":
        assert (per_row > 32).any() and (per_row[per_row > 0] <= 32).any()
        np.testing.assert_array_equal(finite.sum(-1), np.minimum(per_row, 16))
    fill = jax.vmap(lambda d: jr.polygon_fill(d, size, size, True, exact_topk=True))
    np.testing.assert_array_equal(
        tr.polygon_fill(torch.as_tensor(dense), size, size).numpy(),
        np.asarray(fill(jnp.asarray(dense))))


@pytest.mark.parametrize("include_boundary", [True, False])
def test_polygon_fill_pixel_exact_vs_jax(dense_jax, include_boundary):
    """polygon_fill on the same dense polygons: 0 mismatched pixels against
    the JAX exact path, on the test_spline_rasterize shapes and the zigzag
    family of approx_parity_check (the degenerate shapes with the most
    crossings per scanline)."""
    fill = jax.jit(jax.vmap(lambda d: jr.polygon_fill(d, 256, 256, include_boundary,
                                                      exact_topk=True)))
    ref = np.asarray(fill(jnp.asarray(dense_jax)))
    got = tr.polygon_fill(torch.as_tensor(dense_jax.copy()), 256, 256, include_boundary).numpy()
    assert got.shape == ref.shape == (22, 256, 256)
    assert ref.sum() > 0
    np.testing.assert_array_equal(got, ref)


def test_rasterize_linear_spline_and_batch_match_jax(contours):
    """End to end from landmarks: the linear fill is pixel-exact (same
    densification arithmetic); the spline fill differs only where a spline
    vertex moved by its ~1e-4 px rounding difference across a pixel-centre
    line or a rounding boundary (budget 0.01% of pixels). rasterize_batch
    keeps the leading axes."""
    pts = contours[:6]
    ref_lin = np.asarray(jax.vmap(lambda p: jr.rasterize_linear(p, 256, 256))(jnp.asarray(pts)))
    got_lin = tr.rasterize_linear(torch.as_tensor(pts), 256, 256).numpy()
    np.testing.assert_array_equal(got_lin, ref_lin)
    ref_spl = np.asarray(jr.rasterize_batch(jnp.asarray(contours), 256, 256))
    got_spl = tr.rasterize_batch(torch.as_tensor(contours).reshape(2, 11, 21, 2), 256, 256)
    assert got_spl.shape == (2, 11, 256, 256)
    assert (got_spl.reshape(22, 256, 256).numpy() != ref_spl).mean() < 1e-4
