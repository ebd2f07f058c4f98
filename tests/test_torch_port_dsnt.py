"""PyTorch port vs JAX package: DSNT heads and the DSNT moment kernel's
plain version (ops/dsnt.py, ops/dsnt_kernel.py).

Inputs are made with numpy from a seed and handed to both sides. The JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu.ops import dsnt as jd
from contouring_uncertainty_tpu.ops.pallas_dsnt import (
    _raw_moments_pallas,
    _raw_moments_pallas_cols,
)
from contouring_uncertainty_torch.ops import dsnt as td
from contouring_uncertainty_torch.ops import dsnt_kernel

torch.set_num_threads(1)


def _heatmaps(kind, lead, size, seed):
    """Random logits, or sharp off-centre Gaussian-blob logits (1.5-8 px)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(lead))
    if kind == "random":
        x = rng.normal(size=(n, size, size))
    else:
        yy, xx = np.mgrid[0:size, 0:size]
        cx = rng.uniform(0.1 * size, 0.9 * size, n)[:, None, None]
        cy = rng.uniform(0.1 * size, 0.9 * size, n)[:, None, None]
        s = rng.uniform(1.5, 8.0, n)[:, None, None]
        x = -((xx - cx) ** 2 + (yy - cy) ** 2) / (2.0 * s * s)
    return x.reshape(*lead, size, size).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "sharp"])
def test_logits_to_pixel_gaussians_matches_jax(kind, dtype):
    """Both sides take the f32 separable branch on the CPU (bf16 logits are
    upcast first), so only the f32 summation order differs: mu within
    1e-4 px, Sigma within 5e-4 of its scale (E[x^2] - E[x]^2 of a 1.5 px
    blob at 64^2 keeps ~4e-3 of the raw moment, so an f32 rounding there is
    ~2e-5 of Sigma and the two orders accumulate a few dozen of them)."""
    x = _heatmaps(kind, (2, 3, 21), 64, seed=1)
    mu_j, sig_j = jd.logits_to_pixel_gaussians(jnp.asarray(x).astype(dtype))
    mu_t, sig_t = td.logits_to_pixel_gaussians(torch.as_tensor(x).to(getattr(torch, dtype)))
    assert mu_t.shape == (2, 3, 21, 2) and sig_t.shape == (2, 3, 21, 2, 2)
    mu_j, sig_j = np.asarray(mu_j), np.asarray(sig_j)
    np.testing.assert_allclose(mu_t.numpy(), mu_j, atol=1e-4)
    scale = np.abs(sig_j).max(axis=(-2, -1), keepdims=True)
    assert (np.abs(sig_t.numpy() - sig_j) / scale).max() < 5e-4
    _, s_off = td.logits_to_pixel_gaussians(torch.as_tensor(x), use_covar=False)
    assert float(s_off[..., 0, 1].abs().max()) == 0.0


def test_softmax_moments_and_losses_match_jax():
    """flat_softmax, dsnt_moments (with third central moments),
    heatmaps_to_pixel_gaussians, raw6_to_pixel_gaussians, gaussian_nll and
    euclidean_error on the same inputs; f32 reduction-order tolerances."""
    rng = np.random.default_rng(2)
    x = _heatmaps("sharp", (2, 21), 64, seed=3)
    p_j = jd.flat_softmax(jnp.asarray(x))
    p_t = td.flat_softmax(torch.as_tensor(x))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5, atol=1e-9)
    for a, b in zip(td.dsnt_moments(p_t, compute_skew=True),
                    jd.dsnt_moments(p_j, compute_skew=True)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)
    _, mu_t, sig_t = td.heatmaps_to_pixel_gaussians(torch.as_tensor(x))
    _, mu_j, sig_j = jd.heatmaps_to_pixel_gaussians(jnp.asarray(x))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-4)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-3, atol=1e-3)

    raw = np.concatenate([np.ones((5, 1)), rng.uniform(-0.5, 0.5, (5, 2)),
                          rng.uniform(0.3, 0.4, (5, 2)), rng.uniform(-0.01, 0.01, (5, 1))],
                         axis=1).astype(np.float32)
    for a, b in zip(td.raw6_to_pixel_gaussians(torch.as_tensor(raw), 64, 64),
                    jd.raw6_to_pixel_gaussians(jnp.asarray(raw), 64, 64)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-5)

    y = rng.uniform(0, 64, size=(2, 21, 2)).astype(np.float32)
    for a, b in zip(td.gaussian_nll(mu_t, sig_t, torch.as_tensor(y), 0.5, 2.0),
                    jd.gaussian_nll(jnp.asarray(mu_t.numpy()), jnp.asarray(sig_t.numpy()),
                                    jnp.asarray(y), 0.5, 2.0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    np.testing.assert_allclose(td.euclidean_error(mu_t, torch.as_tensor(y)).numpy(),
                               np.asarray(jd.euclidean_error(jnp.asarray(mu_t.numpy()),
                                                             jnp.asarray(y))), rtol=1e-6)


@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_plain_moments_match_jax_pallas_kernel_interpret(layout):
    """The moment kernel's plain version against the JAX Pallas kernels in
    interpret mode (row kernel K2, column kernel K1) on sharp heatmaps at the
    flagship 256^2, where E[x^2] - E[x]^2 cancels to ~1e-3 of the raw
    moments: means within 1e-4 px, variances within 1e-3 relative, in f32
    and on bf16-rounded logits (following tests/test_dsnt.py)."""
    size = 256
    x = _heatmaps("sharp", (7,), size, seed=11).reshape(7, size * size)
    for dtype in (jnp.float32, jnp.bfloat16):
        xj = jnp.asarray(x).astype(dtype)
        if layout == "rows":
            ref = np.asarray(_raw_moments_pallas(xj, size, size, interpret=True))
            got = dsnt_kernel.dsnt_raw_moments(
                torch.as_tensor(np.array(xj.astype(jnp.float32))), size, size)
        else:
            ref = np.asarray(_raw_moments_pallas_cols(xj.T, size, size, interpret=True))
            got = dsnt_kernel.dsnt_raw_moments_cols(
                torch.as_tensor(np.array(xj.T.astype(jnp.float32))), size, size)
        got = got.numpy()
        assert got.shape == ref.shape == (7, 8)
        np.testing.assert_allclose(got[:, 0], 1.0, rtol=1e-6)
        assert np.abs(got[:, 1:3] - ref[:, 1:3]).max() * size / 2 < 1e-4
        var_t = got[:, 3:5] - got[:, 1:3] ** 2
        var_j = ref[:, 3:5] - ref[:, 1:3] ** 2
        np.testing.assert_allclose(var_t, var_j, rtol=1e-3)
        # Third raw moments (skew head): same accumulation, f32 level.
        np.testing.assert_allclose(got[:, 5:8], ref[:, 5:8], atol=2e-6)


def test_moment_wrappers_dispatch_cpu_tensors_to_the_plain_version():
    """On CPU tensors both layouts take the plain version (no launch), and
    a strided column view gives the same moments as the row layout; an f64
    input is accumulated in f64 (the reference chip_smoke holds the kernel
    against)."""
    x = torch.as_tensor(_heatmaps("random", (5,), 32, seed=4).reshape(5, -1))
    before = (dsnt_kernel.row_launches, dsnt_kernel.col_launches)
    rows = dsnt_kernel.dsnt_raw_moments(x, 32, 32)
    cols = dsnt_kernel.dsnt_raw_moments_cols(x.t(), 32, 32)
    assert (dsnt_kernel.row_launches, dsnt_kernel.col_launches) == before
    torch.testing.assert_close(rows, cols, rtol=0, atol=0)
    f64 = dsnt_kernel.raw_moments_plain(x.double(), 32, 32)
    assert f64.dtype == torch.float64
    torch.testing.assert_close(rows.double(), f64, rtol=0, atol=1e-6)
    with pytest.raises(RuntimeError, match="no DSNT moment kernel"):
        dsnt_kernel.dsnt_raw_moments(x.to("meta"), 32, 32)


def test_moment_route_by_layout():
    """On the card a unit pixel stride (row layout, contiguous NCHW heads)
    goes to K2 and a unit heatmap stride (the transpose view of an (HW, N)
    tensor, the column layout) to K1."""
    x = torch.zeros(420, 256 * 256)
    assert dsnt_kernel.moment_route(x) == "rows"
    assert dsnt_kernel.moment_route(x.t().contiguous().t()) == "cols"
    assert dsnt_kernel.moment_route(torch.zeros(256 * 256, 1).t()) == "rows"


@pytest.mark.parametrize("view", ["every_other_pixel", "every_other_column"])
def test_moment_route_refuses_other_layouts(view):
    """A (rows, HW) view with neither a unit pixel nor a unit heatmap stride
    raises: no kernel takes it, and nothing copies it silently."""
    if view == "every_other_pixel":
        bad = torch.zeros(42, 2 * 64 * 64)[:, ::2]
    else:
        bad = torch.zeros(64 * 64, 84)[:, ::2].t()
    assert bad.shape == (42, 64 * 64) and 1 not in bad.stride()
    with pytest.raises(ValueError, match="no DSNT moment kernel takes"):
        dsnt_kernel.moment_route(bad)


ADDRESS = 1 << 40  # a 256-byte aligned allocation, as the caching allocator gives


@pytest.mark.parametrize("hw,n,size,itemsize,vec_bytes", [
    (65536, 420, 256, 2, 8),   # serving view, bf16: 840-byte rows, 8-byte vectors
    (65536, 420, 256, 4, 16),  # the same in f32: 1680-byte rows
    (65536, 21, 256, 2, 2),    # T_e=1, one frame: 42-byte rows, 2-byte vectors
    (4096, 84, 64, 2, 8),      # 64^2, T_e=2 at two frames
])
def test_cols_kernel_layout(hw, n, size, itemsize, vec_bytes):
    """K1's grid: every pixel is in exactly one band (whole image rows) and
    one lane's run, every column in exactly one thread's vector; a vector's
    lanes share a warp, the block fits and the grid has at least one block
    per SM (132 SMs)."""
    lay = dsnt_kernel.cols_layout(hw, n, size, size, itemsize, (n, 1), ADDRESS, 132)
    assert lay.vec_bytes == vec_bytes
    assert lay.n_vec * lay.vec_bytes == n * itemsize
    cols_per_vec = vec_bytes // itemsize
    assert cols_per_vec <= dsnt_kernel.COLS_MAX_COLS
    # Columns: vector t of tile y holds the columns of vector y*tile_vecs + t.
    vecs = [y * lay.tile_vecs + t for y in range(lay.tiles) for t in range(lay.tile_vecs)]
    owned = [v * cols_per_vec + c for v in vecs if v < lay.n_vec for c in range(cols_per_vec)]
    assert sorted(owned) == list(range(n))
    # Pixels: band b holds rows b*H//bands .. (b+1)*H//bands - 1; at step i
    # lane j takes the run of pixels i*lanes*run + j*run .. + run - 1 of the
    # band, which lies in one image row.
    bounds = [b * size // lay.bands for b in range(lay.bands + 1)]
    step = lay.lanes * lay.run
    runs = [(bounds[b] * size + q, bounds[b] * size + q + lay.run)
            for b in range(lay.bands) for i in range(-(-(bounds[b + 1] - bounds[b]) * size // step))
            for j in range(lay.lanes) for q in [i * step + j * lay.run]
            if q < (bounds[b + 1] - bounds[b]) * size]
    pixels = np.concatenate([np.arange(lo, hi) for lo, hi in runs])
    assert np.array_equal(np.sort(pixels), np.arange(hw))
    assert all(lo // size == (hi - 1) // size for lo, hi in runs)
    # Widths of 256 and 64 take whole runs of COLS_LOAD_BYTES (at most COLS_MAX_RUN px).
    assert lay.run == min(dsnt_kernel.COLS_LOAD_BYTES // vec_bytes, dsnt_kernel.COLS_MAX_RUN)
    assert lay.lanes in (1, 2, 4, 8, 16, 32)
    assert -(-lay.tile_vecs * lay.lanes // 32) * 32 <= dsnt_kernel.COLS_MAX_THREADS
    assert lay.bands * lay.tiles >= 132 or lay.bands == size


@pytest.mark.parametrize("shape,strides,size,message", [
    ((4096, 84), (1, 4096), 64, "unit column stride"),  # the row layout handed to K1
    ((4096, 84), (42, 1), 64, "row stride >= N"),       # overlapping pixel rows
    ((4096, 84), (84, 1), 32, "expected 32\\*32"),      # HW that is not H*W
])
def test_cols_kernel_refuses_layouts_it_does_not_take(shape, strides, size, message):
    """K1 raises on an (HW, N) view it does not take: a non-unit column
    stride, a row stride below N, or a pixel count other than H*W."""
    with pytest.raises(ValueError, match=message):
        dsnt_kernel.cols_layout(*shape, size, size, 2, strides, ADDRESS, 132)


@pytest.mark.parametrize("rows,size,itemsize,bands", [
    (420, 256, 2, 1),  # serving view, bf16: one block per heatmap
    (420, 256, 4, 1),  # the same in f32
    (210, 256, 2, 1),  # T_e=5 at two frames: a split is slower here
    (100, 256, 2, 2),  # split until the grid has a block per SM
    (21, 256, 2, 8),   # one frame's heatmaps: up to the cluster limit
    (42, 64, 2, 2),    # 64^2 bf16: one step of 256 loads covers 32 rows
    (42, 64, 4, 4),    # 64^2 f32: 16 rows per step
])
def test_cuda_moment_kernel_bands(rows, size, itemsize, bands):
    """The CUDA row kernel's band split: a power of two up to the cluster
    limit, dividing the image rows, each band at least one full step of 256
    16-byte loads, and doubled only while the grid has fewer blocks than
    SMs (132 SMs)."""
    got = dsnt_kernel.row_bands(rows, size, size, itemsize, 132)
    assert got == bands
    vec = 16 // itemsize
    assert got <= dsnt_kernel.MAX_BANDS and size % got == 0
    assert size // got * (size // vec) >= dsnt_kernel.CUDA_THREADS
    if got > 1:
        assert rows * got // 2 < 132


@pytest.mark.parametrize("width,itemsize", [(60, 2), (6, 4), (4, 2), (4096, 4)])
def test_cuda_moment_kernel_refuses_widths_it_does_not_take(width, itemsize):
    """A width that does not split into 16-byte loads, or whose loads per
    image row do not divide the block, raises (no other kernel takes it)."""
    with pytest.raises(ValueError, match="dsnt CUDA kernel takes widths"):
        dsnt_kernel.row_bands(10, 64, width, itemsize, 132)
