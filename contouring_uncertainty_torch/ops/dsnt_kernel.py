"""DSNT raw-moment kernels: online softmax + eight spatial moments, one read.

Replace the two Pallas kernels of contouring_uncertainty_tpu/ops/pallas_dsnt.py.
Per heatmap they return the normalised raw moments [1, x, y, x^2, y^2, xy,
x^3, y^3] of softmax(logits) over the cell-centre grid ((2i+1)/W) - 1.

- Row layout (`_raw_moments_pallas`, kernel `_dsnt_kernel`; heatmaps as the
  rows of a (rows, H*W) view with unit pixel stride, the port's serving
  path): the CUDA C++ kernel csrc/dsnt_moments.cu, wrapper
  `raw_moments_cuda`. Its source has the design and what bounds it.
- Column layout (`_raw_moments_pallas_cols`, kernel `_dsnt_kernel_cols`;
  heatmaps as the columns of an (HW, N) tensor): the stride-generic Triton
  kernel below, wrapper `raw_moments_triton`, which reads the transpose
  view in place.

`_raw_moments` routes on the layout (`moment_route`): a unit pixel stride
goes to the CUDA kernel, any other stride to the Triton kernel. A row view
that the CUDA kernel does not take raises; it is not handed to Triton.

What bounds the Triton kernel on an H100: device-memory bandwidth by the
roofline (a serving view reads 420 x 65536 bf16 once). Each program loops
over pixel chunks with a running max per heatmap and rescale (online
softmax), accumulating the eight sums per tile lane in f32 registers and
reducing across the tile once, after the loop; the basis comes from two
tiny (W,) and (H,) tables of the JAX kernel's f32 values (`_basis`). When
there are too few heatmaps to fill the card (the column tiles, or small
batches) the pixel range is split over several programs, whose (max, 8
sums) partials a few tiny PyTorch ops rescale and sum. No `tl.dot`: its
TF32/bf16 operands would break the E[x^2] - E[x]^2 cancellation at 256^2
(pallas_dsnt.py:84-92). What holds it above the bound: the block-wide max
of every chunk and the per-pixel rescale of eight accumulators.

The plain PyTorch version (`raw_moments_plain`) is the separable f32 branch
of the JAX `ops/dsnt.py:177-207`, extended to the eight moments; the
wrappers use it for CPU tensors only. `cuda_launches` and `triton_launches`
count the two kernels' launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from contouring_uncertainty_torch.build import build_cuda_library, import_triton
from contouring_uncertainty_torch.ops.coords import normalized_linspace

N_MOM = 8  # [1, x, y, x^2, y^2, xy, x^3, y^3]

cuda_launches = 0  # CUDA row kernel launches since the last reset (plain integer)
triton_launches = 0  # Triton kernel launches since the last reset


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


@functools.cache
def _kernel():
    triton = import_triton()
    import triton.language as tl

    @triton.jit
    def dsnt_moments_kernel(x_ptr, xs_ptr, ys_ptr, out_ptr, rows, hw,
                            stride_r, stride_p, chunks_per_split,
                            WIDTH: tl.constexpr, BLOCK_R: tl.constexpr,
                            BLOCK_P: tl.constexpr, FINAL: tl.constexpr):
        pid_r = tl.program_id(0)
        pid_s = tl.program_id(1)
        r = pid_r * BLOCK_R + tl.arange(0, BLOCK_R)
        rmask = r < rows
        row_off = r.to(tl.int64) * stride_r
        # Finite start so that rows with nothing loaded never form inf - inf.
        m = tl.full((BLOCK_R,), -1.0e30, tl.float32)
        # Per-lane partial sums; reduced across the tile once, after the loop.
        a0 = tl.zeros((BLOCK_R, BLOCK_P), tl.float32)
        a1 = tl.zeros((BLOCK_R, BLOCK_P), tl.float32)
        a2 = tl.zeros((BLOCK_R, BLOCK_P), tl.float32)
        a3 = tl.zeros((BLOCK_R, BLOCK_P), tl.float32)
        a4 = tl.zeros((BLOCK_R, BLOCK_P), tl.float32)
        a5 = tl.zeros((BLOCK_R, BLOCK_P), tl.float32)
        a6 = tl.zeros((BLOCK_R, BLOCK_P), tl.float32)
        a7 = tl.zeros((BLOCK_R, BLOCK_P), tl.float32)
        p_base = pid_s * chunks_per_split * BLOCK_P
        for c in range(chunks_per_split):
            p = p_base + c * BLOCK_P + tl.arange(0, BLOCK_P)
            pmask = p < hw
            ptrs = x_ptr + row_off[:, None] + p.to(tl.int64)[None, :] * stride_p
            x = tl.load(ptrs, mask=rmask[:, None] & pmask[None, :],
                        other=float("-inf")).to(tl.float32)
            # Cell-centre coordinates of each pixel's column and row, read
            # from the (W,) and (H,) tables (L1-resident; a constexpr WIDTH
            # makes the index split a shift and a mask at power-of-2 widths).
            xs = tl.load(xs_ptr + p % WIDTH, mask=pmask, other=0.0)[None, :]
            ys = tl.load(ys_ptr + p // WIDTH, mask=pmask, other=0.0)[None, :]
            m_new = tl.maximum(m, tl.max(x, axis=1))
            alpha = tl.exp(m - m_new)[:, None]
            e = tl.exp(x - m_new[:, None])
            ex = e * xs
            ey = e * ys
            a0 = a0 * alpha + e
            a1 = a1 * alpha + ex
            a2 = a2 * alpha + ey
            a3 = a3 * alpha + ex * xs
            a4 = a4 * alpha + ey * ys
            a5 = a5 * alpha + ex * ys
            a6 = a6 * alpha + ex * (xs * xs)
            a7 = a7 * alpha + ey * (ys * ys)
            m = m_new
        t0 = tl.sum(a0, axis=1)
        t1 = tl.sum(a1, axis=1)
        t2 = tl.sum(a2, axis=1)
        t3 = tl.sum(a3, axis=1)
        t4 = tl.sum(a4, axis=1)
        t5 = tl.sum(a5, axis=1)
        t6 = tl.sum(a6, axis=1)
        t7 = tl.sum(a7, axis=1)
        if FINAL:
            o = out_ptr + r * 8
            tl.store(o + 0, t0 / t0, mask=rmask)
            tl.store(o + 1, t1 / t0, mask=rmask)
            tl.store(o + 2, t2 / t0, mask=rmask)
            tl.store(o + 3, t3 / t0, mask=rmask)
            tl.store(o + 4, t4 / t0, mask=rmask)
            tl.store(o + 5, t5 / t0, mask=rmask)
            tl.store(o + 6, t6 / t0, mask=rmask)
            tl.store(o + 7, t7 / t0, mask=rmask)
        else:
            o = out_ptr + (pid_s * rows + r) * 9
            tl.store(o + 0, m, mask=rmask)
            tl.store(o + 1, t0, mask=rmask)
            tl.store(o + 2, t1, mask=rmask)
            tl.store(o + 3, t2, mask=rmask)
            tl.store(o + 4, t3, mask=rmask)
            tl.store(o + 5, t4, mask=rmask)
            tl.store(o + 6, t5, mask=rmask)
            tl.store(o + 7, t6, mask=rmask)
            tl.store(o + 8, t7, mask=rmask)

    return dsnt_moments_kernel


# (BLOCK_R, BLOCK_P, num_warps) per layout: 8 elements of each tile per
# thread, so the eight per-lane accumulators stay in registers.
ROW_TILE = (2, 1024, 8)  # unit pixel stride: each heatmap streams contiguously
COL_TILE = (128, 16, 8)  # unit row stride: a tile row is 256 contiguous bytes (bf16)


def launch_config(rows: int, hw: int, stride_px: int, n_sm: int):
    """(BLOCK_R, BLOCK_P, splits, chunks_per_split, num_warps) for a
    (rows, hw) view. The pixel range is split only when there are fewer row
    blocks than SMs, into enough splits for ~2 programs per SM."""
    block_r, block_p, warps = ROW_TILE if stride_px == 1 else COL_TILE
    n_rb = -(-rows // block_r)
    n_chunks = -(-hw // block_p)
    splits = 1 if n_rb >= n_sm else min(n_chunks, -(-2 * n_sm // n_rb))
    chunks_per_split = -(-n_chunks // splits)
    splits = -(-n_chunks // chunks_per_split)
    return block_r, block_p, splits, chunks_per_split, warps


def raw_moments_triton(x2d: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Launch the Triton kernel on a CUDA (rows, H*W) view (any strides)."""
    global triton_launches
    if x2d.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"dsnt moment kernel takes bf16/f16/f32, got {x2d.dtype}")
    if not x2d.is_cuda:
        raise ValueError(f"dsnt moment kernel takes a CUDA tensor, got {x2d.device}")
    rows, hw = x2d.shape
    if hw != height * width:
        raise ValueError(f"(rows, HW) view has HW={hw}, expected {height}*{width}")
    kernel = _kernel()
    n_sm = torch.cuda.get_device_properties(x2d.device).multi_processor_count
    block_r, block_p, splits, cps, warps = launch_config(rows, hw, x2d.stride(1), n_sm)
    final = splits == 1
    out = torch.empty((rows, N_MOM) if final else (splits, rows, N_MOM + 1),
                      dtype=torch.float32, device=x2d.device)
    grid = (-(-rows // block_r), splits)
    kernel[grid](x2d, _basis(width, x2d.device), _basis(height, x2d.device), out,
                 rows, hw, x2d.stride(0), x2d.stride(1), cps, WIDTH=width,
                 BLOCK_R=block_r, BLOCK_P=block_p, FINAL=final, num_warps=warps)
    triton_launches += 1
    if final:
        return out
    # Combine the split partials: rescale each split's sums to the global max.
    m = out[..., 0]
    w = torch.exp(m - m.amax(dim=0, keepdim=True))
    t = (out[..., 1:] * w[..., None]).sum(dim=0)
    return t / t[:, :1]


# The CUDA row kernel (csrc/dsnt_moments.cu): its dtype codes, threads per
# block and largest cluster. The band split pays only while there are fewer
# heatmaps than SMs: at 21 and 42 heatmaps of 256^2 (T_e=1) it is 1.5-1.8x
# faster than one block per heatmap, at 210 (T_e=5) and 420 (T_e=10) it is
# slower (chip_smoke.py [8] times every split at these counts; PERF.md has
# the numbers).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
CUDA_THREADS = 256
MAX_BANDS = 8


def moment_route(stride_px: int) -> str:
    """Which kernel takes a (rows, HW) view on the card: a unit pixel stride
    (row layout, K2's) the CUDA kernel, any other (column layout) Triton."""
    return "cuda" if stride_px == 1 else "triton"


def row_bands(rows: int, height: int, width: int, itemsize: int, n_sm: int) -> int:
    """Bands of whole image rows per heatmap for the CUDA row kernel (one
    block, and one member of the heatmap's cluster, each): doubled from 1
    while the grid has fewer blocks than SMs and each band keeps at least
    one full step of CUDA_THREADS 16-byte loads. Raises on a
    width the kernel does not take."""
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


@functools.cache
def _cuda_library():
    lib = ctypes.CDLL(str(build_cuda_library("dsnt_moments")))
    ptr, num = ctypes.c_void_p, ctypes.c_int
    lib.cu_dsnt_moments.argtypes = [ptr, num, num, ctypes.c_longlong, num, num, num,
                                    ptr, ptr, ptr, ptr]
    lib.cu_dsnt_moments.restype = num
    return lib


def raw_moments_cuda(x2d: torch.Tensor, height: int, width: int,
                     bands: int | None = None) -> torch.Tensor:
    """Launch the CUDA row kernel on a CUDA (rows, H*W) view with unit pixel
    stride and 16-byte aligned rows. `bands` defaults to `row_bands`."""
    global cuda_launches
    if x2d.dtype not in DTYPE_CODES:
        raise TypeError(f"dsnt moment kernel takes bf16/f16/f32, got {x2d.dtype}")
    if not x2d.is_cuda:
        raise ValueError(f"dsnt moment kernel takes a CUDA tensor, got {x2d.device}")
    rows, hw = x2d.shape
    if hw != height * width:
        raise ValueError(f"(rows, HW) view has HW={hw}, expected {height}*{width}")
    vec = 16 // x2d.element_size()
    if (x2d.stride(1) != 1 or (rows > 1 and x2d.stride(0) % vec)
            or x2d.data_ptr() % 16):
        raise ValueError(f"dsnt CUDA kernel takes 16-byte aligned rows with unit pixel "
                         f"stride, got strides {x2d.stride()}")
    if bands is None:
        n_sm = torch.cuda.get_device_properties(x2d.device).multi_processor_count
        bands = row_bands(rows, height, width, x2d.element_size(), n_sm)
    out = torch.empty((rows, N_MOM), dtype=torch.float32, device=x2d.device)
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    err = _cuda_library().cu_dsnt_moments(
        x2d.data_ptr(), DTYPE_CODES[x2d.dtype], rows, x2d.stride(0) if rows > 1 else hw,
        height, width, bands, _basis(width, x2d.device).data_ptr(),
        _basis(height, x2d.device).data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dsnt moment kernel launch failed: CUDA error {err}")
    cuda_launches += 1
    return out


def _raw_moments(x2d: torch.Tensor, height: int, width: int) -> torch.Tensor:
    if x2d.device.type == "cpu":
        return raw_moments_plain(x2d, height, width)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"no DSNT moment kernel for device {x2d.device}")
    if moment_route(x2d.stride(1)) == "cuda":
        return raw_moments_cuda(x2d, height, width)
    return raw_moments_triton(x2d, height, width)


def dsnt_raw_moments(flat_logits: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Row layout (K2's): flat_logits (Rows, H*W) -> (Rows, 8) f32. On the
    card a contiguous view takes the CUDA kernel."""
    return _raw_moments(flat_logits, height, width)


def dsnt_raw_moments_cols(flat_t: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Column layout (K1's): flat_t (H*W, N), one heatmap per column ->
    (N, 8) f32. On the card the Triton kernel reads the transpose view in
    place."""
    return _raw_moments(flat_t.t(), height, width)
