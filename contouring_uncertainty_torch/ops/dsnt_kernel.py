"""DSNT raw-moment kernels: online softmax + eight spatial moments, one read.

Replace the two Pallas kernels of contouring_uncertainty_tpu/ops/pallas_dsnt.py
with the two CUDA C++ kernels of csrc/dsnt_moments.cu (bound with ctypes).
Per heatmap they return the normalised raw moments [1, x, y, x^2, y^2, xy,
x^3, y^3] of softmax(logits) over the cell-centre grid ((2i+1)/W) - 1.

- K2, row layout (`_raw_moments_pallas`, kernel `_dsnt_kernel`; heatmaps as
  the rows of a (rows, H*W) view with unit pixel stride, the port's serving
  path): wrapper `raw_moments_cuda`.
- K1, column layout (`_raw_moments_pallas_cols`, kernel `_dsnt_kernel_cols`;
  heatmaps as the columns of an (HW, N) tensor with unit column stride):
  wrapper `raw_moments_cols_cuda`.

`_raw_moments` routes a (rows, HW) view by its layout (`moment_route`): a
unit pixel stride goes to K2, a unit heatmap stride (the transpose of an
(HW, N) tensor) to K1, and any other layout raises; nothing is copied into
a layout a kernel takes. The source has each kernel's design and what
bounds it.

The plain PyTorch version (`raw_moments_plain`) is the separable f32 branch
of the JAX `ops/dsnt.py:177-207`, extended to the eight moments; the
wrappers use it for CPU tensors only. `row_launches` and `col_launches`
count the two kernels' launches.

Gradients: `dsnt_raw_moments` and `dsnt_raw_moments_cols` go through one
`torch.autograd.Function` per layout on every device (the counterparts of
the JAX custom VJPs `dsnt_raw_moments` and `dsnt_raw_moments_cols`,
pallas_dsnt.py:241-317). The kernels write their moments through ctypes,
which records no graph, so without the Functions no gradient would reach
the logits on the card. The backward is the softmax-moment adjoint of the
JAX `_bwd`/`_bwd_cols` (XLA there, plain PyTorch here): p recomputed from
the saved logits, the separable basis instead of an (HW, 8) matmul.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from contouring_uncertainty_torch.build import build_cuda_library
from contouring_uncertainty_torch.ops.coords import normalized_linspace

N_MOM = 8  # [1, x, y, x^2, y^2, xy, x^3, y^3]

row_launches = 0  # K2 launches since the last reset (plain integer)
col_launches = 0  # K1 launches since the last reset


def raw_moments_plain(x2d: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(rows, H*W) logits -> (rows, 8) normalised raw moments, plain PyTorch.

    Separable reductions in the native (rows, H, W) layout, accumulated in
    f32 (f64 for f64 inputs, the reference the kernel is held against)."""
    acc = torch.float64 if x2d.dtype == torch.float64 else torch.float32
    t = x2d.reshape(-1, height, width).to(acc)
    xs = (2.0 * torch.arange(width, dtype=acc, device=t.device) + 1.0) / width - 1.0
    ys = (2.0 * torch.arange(height, dtype=acc, device=t.device) + 1.0) / height - 1.0
    m = t.amax(dim=(-2, -1), keepdim=True)
    e = torch.exp(t - m)
    col = e.sum(-2)  # (rows, W) marginal over y
    row = e.sum(-1)  # (rows, H) marginal over x
    tx = (e * xs).sum(-1)  # (rows, H) x-weighted rows
    s0 = row.sum(-1)
    raw = torch.stack([
        s0,
        (col * xs).sum(-1),
        (row * ys).sum(-1),
        (col * (xs * xs)).sum(-1),
        (row * (ys * ys)).sum(-1),
        (tx * ys).sum(-1),
        (col * (xs * xs * xs)).sum(-1),
        (row * (ys * ys * ys)).sum(-1),
    ], dim=-1)
    return raw / s0[:, None]


@functools.lru_cache(maxsize=16)
def _basis(length: int, device: torch.device) -> torch.Tensor:
    """Cell-centre coordinates (2i+1)/L - 1 of one axis, f32, on `device`:
    the JAX kernel's basis formula (pallas_dsnt._basis_cols), evaluated once
    per (length, device) with IEEE f32 arithmetic on the host."""
    return normalized_linspace(length).to(device)


# K2, the row kernel of csrc/dsnt_moments.cu: its dtype codes, threads per
# block and largest cluster. The band split pays only while there are fewer
# heatmaps than SMs: at 21 and 42 heatmaps of 256^2 (T_e=1) it is 1.5-1.8x
# faster than one block per heatmap, at 210 (T_e=5) and 420 (T_e=10) it is
# slower (PERF.md has the numbers).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
CUDA_THREADS = 256
MAX_BANDS = 8

# K1, the column kernel of csrc/dsnt_moments.cu: threads per block (its
# kColsMaxThreads) and columns per thread (kColsMaxCols) at most; vectors
# of a pixel row one block takes at most (more are split into column
# tiles); blocks per SM aimed at by the band split (one block per SM
# measured as fast as two, with half the partials: PERF.md).
COLS_MAX_THREADS = 448
COLS_MAX_COLS = 4
COLS_MAX_TILE = 256
COLS_BLOCKS_PER_SM = 1
# Bytes a thread loads per run of pixels (kColsLoadBytes), in at most
# COLS_MAX_RUN pixels (kColsMaxRun).
COLS_LOAD_BYTES = 64
COLS_MAX_RUN = 16


def moment_route(x2d: torch.Tensor) -> str:
    """Which kernel takes a (rows, HW) view on the card: "rows" (K2) for a
    unit pixel stride, "cols" (K1) for a unit heatmap stride (the transpose
    of an (HW, N) tensor). Any other layout raises: no kernel takes it."""
    rows, hw = x2d.shape
    if x2d.stride(1) == 1 or hw == 1:
        return "rows"
    if x2d.stride(0) == 1 or rows == 1:
        return "cols"
    raise ValueError(f"no DSNT moment kernel takes a (rows, HW) view with strides "
                     f"{x2d.stride()}: one of them must be 1")


def row_bands(rows: int, height: int, width: int, itemsize: int, n_sm: int) -> int:
    """Bands of whole image rows per heatmap for K2 (one block, and one
    member of the heatmap's cluster, each): doubled from 1 while the grid
    has fewer blocks than SMs and each band keeps at least one full step of
    CUDA_THREADS 16-byte loads. Raises on a width the kernel does not take."""
    vec = 16 // itemsize
    if width < vec or width % vec or CUDA_THREADS % (width // vec):
        raise ValueError(f"dsnt CUDA kernel takes widths w with {vec} | w and "
                         f"(w / {vec}) | {CUDA_THREADS}, got {width}")
    bands = 1
    while (bands < MAX_BANDS and rows * bands < n_sm
           and height % (2 * bands) == 0
           and height // (2 * bands) * (width // vec) >= CUDA_THREADS):
        bands *= 2
    return bands


class ColsLayout(NamedTuple):
    """K1's launch: vector bytes per thread, vectors per pixel row, column
    tiles of `tile_vecs` vectors (grid y), pixel lanes per vector (a power
    of two up to 32; block = tile_vecs x lanes threads, lanes fastest,
    rounded up to whole warps), pixels per run of a lane (one image row:
    step i of lane j is pixels i*lanes*run + j*run .. + run - 1 of the band)
    and bands of whole image rows (grid x; band b holds rows b*H//bands ..
    (b+1)*H//bands - 1)."""

    vec_bytes: int
    n_vec: int
    tile_vecs: int
    tiles: int
    lanes: int
    run: int
    bands: int


def cols_layout(hw: int, n: int, height: int, width: int, itemsize: int,
                strides: tuple, address: int, n_sm: int) -> ColsLayout:
    """K1's launch for an (HW, N) tensor with these strides at this byte
    address. The vector is the largest of 16, 8, 4 and 2 bytes that divides
    the address, N and the row stride in bytes, and holds at most
    COLS_MAX_COLS columns. A run is COLS_LOAD_BYTES of vectors (at most
    COLS_MAX_RUN pixels) where it divides the width, else one pixel. Lanes
    are the most (a power of two up to 32) that keep a block within
    COLS_MAX_THREADS threads; bands give COLS_BLOCKS_PER_SM blocks per SM.
    Raises on a layout the kernel does not take."""
    row_stride, col_stride = strides
    ld = row_stride if hw > 1 else n
    if (col_stride != 1 and n > 1) or ld < n:
        raise ValueError(f"dsnt column kernel takes (HW, N) views with unit column stride "
                         f"and row stride >= N, got shape ({hw}, {n}), strides {strides}")
    if hw != height * width:
        raise ValueError(f"(HW, N) view has HW={hw}, expected {height}*{width}")
    g = math.gcd(address, n * itemsize, ld * itemsize)
    vec_bytes = min(g & -g, 16, COLS_MAX_COLS * itemsize)
    n_vec = n * itemsize // vec_bytes
    tiles = -(-n_vec // COLS_MAX_TILE)
    tile_vecs = -(-n_vec // tiles)
    run = min(COLS_LOAD_BYTES // vec_bytes, COLS_MAX_RUN)
    if width % run:
        run = 1
    lanes = 1 << min(5, (COLS_MAX_THREADS // tile_vecs).bit_length() - 1)
    bands = min(height, -(-COLS_BLOCKS_PER_SM * n_sm // tiles))
    return ColsLayout(vec_bytes, n_vec, tile_vecs, tiles, lanes, run, bands)


@functools.cache
def _cuda_library():
    lib = ctypes.CDLL(str(build_cuda_library("dsnt_moments")))
    ptr, num, big = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cu_dsnt_moments.argtypes = [ptr, num, num, big, num, num, num, ptr, ptr, ptr, ptr]
    lib.cu_dsnt_moments_cols.argtypes = [ptr, num, num, num, big, num, num, num, num, num, num,
                                         num, ptr, ptr, ptr, ptr, ptr]
    lib.cu_dsnt_moments.restype = lib.cu_dsnt_moments_cols.restype = num
    return lib


def _check_input(x: torch.Tensor, height: int, width: int, hw: int) -> None:
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"dsnt moment kernel takes bf16/f16/f32, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError(f"dsnt moment kernel takes a CUDA tensor, got {x.device}")
    if hw != height * width:
        raise ValueError(f"view has HW={hw}, expected {height}*{width}")


def raw_moments_cuda(x2d: torch.Tensor, height: int, width: int,
                     bands: int | None = None) -> torch.Tensor:
    """Launch K2 on a CUDA (rows, H*W) view with unit pixel stride and
    16-byte aligned rows. `bands` defaults to `row_bands`."""
    global row_launches
    rows, hw = x2d.shape
    _check_input(x2d, height, width, hw)
    vec = 16 // x2d.element_size()
    if (x2d.stride(1) != 1 or (rows > 1 and x2d.stride(0) % vec)
            or x2d.data_ptr() % 16):
        raise ValueError(f"dsnt CUDA kernel takes 16-byte aligned rows with unit pixel "
                         f"stride, got strides {x2d.stride()}")
    if bands is None:
        bands = row_bands(rows, height, width, x2d.element_size(), _sm_count(x2d.device))
    out = torch.empty((rows, N_MOM), dtype=torch.float32, device=x2d.device)
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    err = _cuda_library().cu_dsnt_moments(
        x2d.data_ptr(), DTYPE_CODES[x2d.dtype], rows, x2d.stride(0) if rows > 1 else hw,
        height, width, bands, _basis(width, x2d.device).data_ptr(),
        _basis(height, x2d.device).data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dsnt moment kernel launch failed: CUDA error {err}")
    row_launches += 1
    return out


def raw_moments_cols_cuda(flat_t: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Launch K1 on a CUDA (H*W, N) tensor with unit column stride (any row
    stride >= N): (N, 8) f32, launched as `cols_layout` says."""
    global col_launches
    hw, n = flat_t.shape
    _check_input(flat_t, height, width, hw)
    out = torch.empty((n, N_MOM), dtype=torch.float32, device=flat_t.device)
    if n == 0:
        return out
    n_sm = torch.cuda.get_device_properties(flat_t.device).multi_processor_count
    lay = cols_layout(hw, n, height, width, flat_t.element_size(), flat_t.stride(),
                      flat_t.data_ptr(), n_sm)
    part = (torch.empty((lay.bands, N_MOM + 1, n), dtype=torch.float32, device=flat_t.device)
            if lay.bands > 1 else None)
    stream = torch.cuda.current_stream(flat_t.device).cuda_stream
    err = _cuda_library().cu_dsnt_moments_cols(
        flat_t.data_ptr(), DTYPE_CODES[flat_t.dtype], hw, n,
        flat_t.stride(0) if hw > 1 else n, height, width, lay.vec_bytes, lay.tile_vecs,
        lay.lanes, lay.run, lay.bands, _basis(width, flat_t.device).data_ptr(),
        _basis(height, flat_t.device).data_ptr(),
        None if part is None else part.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dsnt column moment kernel launch failed: CUDA error {err}")
    col_launches += 1
    return out


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (a kernel takes it), False for a CPU tensor
    (the plain version takes it); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no DSNT moment kernel for device {x.device}")
    return x.device.type == "cuda"


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _raw_moments(x2d: torch.Tensor, height: int, width: int,
                 whole_rows: int | None = None) -> torch.Tensor:
    """Moments of a (rows, HW) view by its route. `whole_rows`: the rows of
    the whole batch when x2d holds one rank's rows of it; K2 then splits
    each heatmap into the whole batch's bands (`row_bands`), so a heatmap's
    moments, summed band by band, do not depend on the rank count."""
    if not _on_card(x2d):
        return raw_moments_plain(x2d, height, width)
    if x2d.shape[0] == 0:  # a rank dealt no rows: nothing to launch
        return torch.empty((0, N_MOM), dtype=torch.float32, device=x2d.device)
    if moment_route(x2d) == "rows":
        bands = None if whole_rows is None else row_bands(
            whole_rows, height, width, x2d.element_size(), _sm_count(x2d.device))
        return raw_moments_cuda(x2d, height, width, bands)
    return raw_moments_cols_cuda(x2d.t(), height, width)


def moments_adjoint(x2d: torch.Tensor, g: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """Gradient of the normalised raw moments with respect to the logits:
    (rows, HW) logits and (rows, 8) cotangents -> (rows, HW) in the logits'
    dtype. dx = p * (B g - sum_i p_i (B g)_i), with p recomputed in f32 (f64
    for f64 logits) and B g = g0 + g1 x + g2 y + g3 x^2 + g4 y^2 + g5 x y +
    g6 x^3 + g7 y^3 built from its separable (rows, W) and (rows, H) parts."""
    acc = torch.float64 if x2d.dtype == torch.float64 else torch.float32
    p = torch.softmax(x2d.to(acc), dim=-1).reshape(-1, height, width)
    g = g.to(acc)
    xs = normalized_linspace(width, dtype=acc, device=x2d.device)
    ys = normalized_linspace(height, dtype=acc, device=x2d.device)
    gx = g[:, 0:1] + xs * (g[:, 1:2] + xs * (g[:, 3:4] + xs * g[:, 6:7]))  # (rows, W)
    gy = ys * (g[:, 2:3] + ys * (g[:, 4:5] + ys * g[:, 7:8]))  # (rows, H)
    bg = gx[:, None, :] + (gy[:, :, None] + (g[:, 5, None, None] * ys[:, None]) * xs)
    inner = (p * bg).sum(dim=(-2, -1), keepdim=True)
    return (p * (bg - inner)).reshape(x2d.shape).to(x2d.dtype)


class RowMoments(torch.autograd.Function):
    """Row layout (K2's): (Rows, H*W) logits -> (Rows, 8); the counterpart
    of the JAX custom VJP `dsnt_raw_moments` (`_fwd`/`_bwd`)."""

    @staticmethod
    def forward(ctx, flat_logits, height, width, whole_rows=None):
        ctx.save_for_backward(flat_logits)
        ctx.size = (height, width)
        return _raw_moments(flat_logits, height, width, whole_rows)

    @staticmethod
    def backward(ctx, g):
        (flat_logits,) = ctx.saved_tensors
        return moments_adjoint(flat_logits, g, *ctx.size), None, None, None


class ColMoments(torch.autograd.Function):
    """Column layout (K1's): (H*W, N) logits -> (N, 8); the counterpart of
    the JAX custom VJP `dsnt_raw_moments_cols` (`_fwd_cols`/`_bwd_cols`).
    The gradient is the row adjoint of the transposed view, returned as an
    (H*W, N) view."""

    @staticmethod
    def forward(ctx, flat_t, height, width):
        ctx.save_for_backward(flat_t)
        ctx.size = (height, width)
        return _raw_moments(flat_t.t(), height, width)

    @staticmethod
    def backward(ctx, g):
        (flat_t,) = ctx.saved_tensors
        return moments_adjoint(flat_t.t(), g, *ctx.size).t(), None, None


def dsnt_raw_moments(flat_logits: torch.Tensor, height: int, width: int,
                     whole_rows: int | None = None) -> torch.Tensor:
    """Row layout (K2's): flat_logits (Rows, H*W) -> (Rows, 8) f32,
    differentiable on every device. `whole_rows`: the rows of the whole
    batch when these are one rank's (`_raw_moments`)."""
    return RowMoments.apply(flat_logits, height, width, whole_rows)


def dsnt_raw_moments_cols(flat_t: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Column layout (K1's): flat_t (H*W, N), one heatmap per column ->
    (N, 8) f32, differentiable on every device."""
    return ColMoments.apply(flat_t, height, width)
