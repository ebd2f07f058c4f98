"""PyTorch port vs JAX package: the clinical metric formulas
(utils/clinical.py), batched over leading axes in the port and vmapped in
JAX, on the same numpy inputs.

Tolerances (f32 throughout; sums run in another order than XLA's):
- areas, FAC and the base markers of the mask GLS: exact;
- mask perimeters and longitudinal lengths: 1e-6 relative (a 16-term dot
  product of exact counts);
- spline perimeters, areas and GLS: 1e-5 relative (1000-point arc length);
- principal axis: the centroid exact, the unit direction within 2e-5;
- disk diameters and Simpson volumes: 2e-5 relative. The chord step is the
  difference of two neighbouring `linspace` values, which XLA on the CPU
  rounds one ulp away from the formula, and that ulp is ~3e-6 of the step
  (5e-6 of a volume, measured on 300 ellipses: no sample crossed a
  rounding boundary).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu.utils import clinical as JC
from contouring_uncertainty_torch.utils import clinical as TC

torch.set_num_threads(1)

SIZE = 64
VOXELS = (0.62, 0.42)


def _ellipse(a, b, cy, cx, angle=0.0, size=SIZE):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    xr = (xx - cx) * np.cos(angle) + (yy - cy) * np.sin(angle)
    yr = -(xx - cx) * np.sin(angle) + (yy - cy) * np.cos(angle)
    return ((xr / b) ** 2 + (yr / a) ** 2 <= 1).astype(np.float32)


@pytest.fixture(scope="module")
def masks():
    """(2, 4, 64, 64) f32 {0, 1}: ellipses (tilted, off-centre, one with
    speckle holes), random masks, and an empty one."""
    rng = np.random.default_rng(0)
    out = [_ellipse(20, 11, 30, 33), _ellipse(18, 9, 28, 30, 0.4),
           _ellipse(15, 12, 35, 25, -0.7), _ellipse(22, 10, 31, 34) * (rng.random((SIZE, SIZE)) > 0.1),
           (rng.random((SIZE, SIZE)) > 0.7).astype(np.float32),
           (rng.random((SIZE, SIZE)) > 0.95).astype(np.float32),
           _ellipse(6, 4, 50, 10), np.zeros((SIZE, SIZE), np.float32)]
    return np.stack(out).astype(np.float32).reshape(2, 4, SIZE, SIZE)


@pytest.fixture(scope="module")
def lv_masks():
    """(2, 4, 64, 64): LV-like ED masks (upright, tilted both ways, one
    with speckle holes) and their ES masks (shrunk; the last one empty).
    Simpson volumes are held on these: on a near-isotropic mask (random
    pixels) the principal axis is ill-conditioned, and f32 rounding of the
    second moments alone turns it."""
    rng = np.random.default_rng(2)
    holes = rng.random((SIZE, SIZE)) > 0.1
    ed = [_ellipse(20, 11, 30, 33), _ellipse(18, 9, 28, 30, 0.4),
          _ellipse(15, 9, 35, 25, -0.7), _ellipse(22, 10, 31, 34) * holes]
    es = [_ellipse(17, 9, 31, 33), _ellipse(15, 8, 29, 30, 0.35),
          _ellipse(12, 8, 35, 26, -0.6), np.zeros((SIZE, SIZE), np.float32)]
    return np.stack([np.stack(ed), np.stack(es)]).astype(np.float32)


@pytest.fixture(scope="module")
def contours():
    """(3, 2, 21, 2) LV-like spline landmarks, the second frame shrunk."""
    rng = np.random.default_rng(1)
    t = np.linspace(0, np.pi, 21)
    out = []
    for _ in range(3):
        ed = np.stack([32 + 14 * np.cos(t), 52 - 36 * np.sin(t)], -1)
        ed += rng.normal(scale=0.8, size=ed.shape)
        es = 32 + (ed - 32) * rng.uniform(0.8, 0.95)
        out.append(np.stack([ed, es]))
    return np.stack(out).astype(np.float32)


def _seg_frame(scale, size=SIZE):
    """LV + myocardium label map (the JAX package's mask-GLS test frame)."""
    yy, xx = np.mgrid[0:size, 0:size]
    cy, cx = size * 0.62, size * 0.5
    ry, rx = size * 0.36 * scale, size * 0.2 * scale
    lv = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0) & (yy <= cy)
    outer = (((yy - cy) / (ry + 5)) ** 2 + ((xx - cx) / (rx + 5)) ** 2 <= 1.0) & (yy <= cy)
    seg = np.zeros((size, size), np.float32)
    seg[outer & ~lv] = 2
    seg[lv] = 1
    return seg


@pytest.fixture(scope="module")
def segs(masks):
    """(2, 3, 64, 64) label maps: LV with MYO at three scales; an LV
    ellipse alone, speckle, and an empty map (invalid base)."""
    return np.stack([np.stack([_seg_frame(s) for s in (1.0, 0.9, 0.8)]),
                     np.stack([masks[0, 0], masks[1, 1], masks[1, 3]])]).astype(np.float32)


def _vmap_lead(fn, n_lead):
    for _ in range(n_lead):
        fn = jax.vmap(fn)
    return jax.jit(fn)


def test_areas_and_fac_are_exact(masks):
    np.testing.assert_array_equal(TC.lv_area(torch.as_tensor(masks)).numpy(),
                                  np.asarray(JC.lv_area(jnp.asarray(masks))))
    np.testing.assert_array_equal(TC.lv_area(torch.as_tensor(masks), 0.26).numpy(),
                                  np.asarray(JC.lv_area(jnp.asarray(masks), 0.26)))
    fac_t = TC.lv_fac(torch.as_tensor(masks[0]), torch.as_tensor(masks[1])).numpy()
    fac_j = np.asarray(JC.lv_fac(jnp.asarray(masks[0]), jnp.asarray(masks[1])))
    np.testing.assert_array_equal(fac_t, fac_j)
    seq_t = TC.fac_sequence(torch.as_tensor(masks)).numpy()
    seq_j = np.asarray(_vmap_lead(JC.fac_sequence, 1)(jnp.asarray(masks)))
    np.testing.assert_array_equal(seq_t, seq_j)
    err_t = TC.metric_error(torch.as_tensor(fac_t), torch.tensor(0.3), relative=True).numpy()
    np.testing.assert_array_equal(err_t, np.asarray(JC.metric_error(fac_j, 0.3, relative=True)))


def test_contour_metrics_match_jax(contours):
    c = torch.as_tensor(contours)
    flat = jnp.asarray(contours.reshape(-1, 21, 2))
    for name in ("contour_perimeter", "contour_area"):
        got = getattr(TC, name)(c).numpy().reshape(-1)
        ref = np.asarray(jax.vmap(getattr(JC, name))(flat))
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=name)
    gls_t = TC.gls(c[:, 0], c[:, 1]).numpy()
    gls_j = np.asarray(jax.vmap(JC.gls)(jnp.asarray(contours[:, 0]), jnp.asarray(contours[:, 1])))
    assert (gls_j > 0.03).all()
    np.testing.assert_allclose(gls_t, gls_j, rtol=1e-5)
    seq_t = TC.gls_sequence(c).numpy()
    seq_j = np.asarray(jax.vmap(JC.gls_sequence)(jnp.asarray(contours)))
    np.testing.assert_allclose(seq_t, seq_j, rtol=1e-5, atol=1e-5)


def test_mask_perimeter_and_base_markers_match_jax(masks, segs):
    per_t = TC.mask_perimeter(torch.as_tensor(masks)).numpy()
    per_j = np.asarray(_vmap_lead(JC.mask_perimeter, 2)(jnp.asarray(masks)))
    assert per_j[-1, -1] == 0 and (per_j[:, :3] > 20).all()
    np.testing.assert_allclose(per_t, per_j, rtol=1e-6)
    for use_myo in (True, False):
        fn = _vmap_lead(lambda s, u=use_myo: JC.mask_endo_base(s, use_myo=u), 2)
        (jyl, jxl), (jyr, jxr), jvalid = fn(jnp.asarray(segs))
        (tyl, txl), (tyr, txr), tvalid = TC.mask_endo_base(torch.as_tensor(segs), use_myo=use_myo)
        for got, ref in ((tyl, jyl), (txl, jxl), (tyr, jyr), (txr, jxr), (tvalid, jvalid)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert np.asarray(jvalid)[0].all() and not np.asarray(jvalid)[1, 2]


def test_base_marker_ties_take_the_first_pixel():
    """`jnp.argmax` takes the first maximum: on a frontier whose bottom row
    holds several pixels, both packages pick its left-most pixel of each
    half (the port by an explicit first-index rule, the same on any
    device)."""
    seg = np.zeros((2, 16, 16), np.float32)
    seg[0, 4:10, 3:13] = 1  # flat-bottomed LV: ties along row 9
    seg[1, 6:9, 6:9] = 1
    seg[1, 2:6, 5:10] = 2  # myocardium above: the frontier is its edge
    for use_myo in (False, True):
        ref = jax.vmap(lambda s, u=use_myo: JC.mask_endo_base(s, use_myo=u))(jnp.asarray(seg))
        got = TC.mask_endo_base(torch.as_tensor(seg), use_myo=use_myo)
        for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    (yl, xl), (yr, xr), _ = TC.mask_endo_base(torch.as_tensor(seg[:1]), use_myo=False)
    assert (yl.item(), xl.item(), yr.item(), xr.item()) == (9.0, 3.0, 9.0, 8.0)


def test_mask_gls_matches_jax(segs):
    for use_myo in (True, False):
        got = TC.mask_longitudinal_length(torch.as_tensor(segs), use_myo=use_myo).numpy()
        ref = np.asarray(_vmap_lead(
            lambda s, u=use_myo: JC.mask_longitudinal_length(s, use_myo=u), 2)(jnp.asarray(segs)))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        # no myocardium (second row) has no base with use_myo; empty has none
        assert np.isnan(ref).sum() == (3 if use_myo else 1)
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    got = TC.gls_mask_sequence(torch.as_tensor(segs[0])).numpy()
    ref = np.asarray(JC.gls_mask_sequence(jnp.asarray(segs[0])))
    assert ref[1] < -2.0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_principal_axis_and_disk_diameters_match_jax(lv_masks):
    """Anisotropic voxels; the empty mask gives NaN lengths in both (JAX's
    nanmin/nanmax over no foreground) and zero diameters."""
    flat = lv_masks.reshape(-1, SIZE, SIZE)
    axis_t = TC._principal_axis(torch.as_tensor(flat))
    axis_j = jax.vmap(JC._principal_axis)(jnp.asarray(flat))
    # The centroid is exact (integer sums); the unit direction within 2e-5
    # (an angle of 2e-5 rad: its small component cancels on upright masks).
    for got, ref in zip(axis_t[:2], axis_j[:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(axis_t[2:], axis_j[2:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    vs = np.asarray(VOXELS, np.float32)
    d_t, s_t = TC.lv_disk_diameters(torch.as_tensor(flat), vs)
    d_j, s_j = jax.vmap(JC.lv_disk_diameters, in_axes=(0, None))(jnp.asarray(flat), jnp.asarray(vs))
    d_j, s_j = np.asarray(d_j), np.asarray(s_j)
    assert np.isnan(s_j[-1]) and np.isnan(s_t[-1].item()) and (d_j[-1] == 0).all()
    assert d_t.shape == (8, 20) and (d_j[:-1] > 0).sum() > 120
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=2e-5)
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-6)


def test_simpson_volumes_and_ef_match_jax(lv_masks):
    """Both views' ED and ES masks in one batched call, with a different
    voxel spacing per view; an empty mask makes that pair's volumes NaN."""
    ed, es = lv_masks
    vs2, vs4 = np.asarray(VOXELS, np.float32), np.asarray((0.3, 0.3), np.float32)
    a4c_ed, a4c_es = ed[[1, 2, 0, 3]], es[[1, 2, 0, 0]]
    got = TC.compute_left_ventricle_volumes(torch.as_tensor(ed), torch.as_tensor(es), vs2,
                                            torch.as_tensor(a4c_ed), torch.as_tensor(a4c_es), vs4)
    ref = jax.vmap(JC.compute_left_ventricle_volumes, in_axes=(0, 0, None, 0, 0, None))(
        jnp.asarray(ed), jnp.asarray(es), jnp.asarray(vs2), jnp.asarray(a4c_ed),
        jnp.asarray(a4c_es), jnp.asarray(vs4))
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        assert np.isnan(r).sum() == 1 and (r[:3] > 0).all()
        np.testing.assert_allclose(g, r, rtol=2e-5)
    ef_t = TC.ejection_fraction(*got).numpy()
    ef_j = np.asarray(JC.ejection_fraction(*ref))
    assert (ef_j[:3] > 0.1).all()
    np.testing.assert_allclose(ef_t, ef_j, rtol=1e-4)
    vol_t = TC.lv_volume(torch.ones(20) * 30, torch.ones(20) * 20, torch.tensor(4.0)).item()
    np.testing.assert_allclose(vol_t, float(JC.lv_volume(jnp.ones(20) * 30, jnp.ones(20) * 20, 4.0)),
                               rtol=1e-6)
