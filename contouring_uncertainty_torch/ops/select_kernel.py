"""Exact min-k scanline crossing selection: wrapper of csrc/min_k_crossings.cu.

Replaces contouring_uncertainty_tpu/ops/pallas_select.py (`min_k_crossings`,
Pallas kernel `_select_kernel`). For each closed dense polygon (E, 2) and
each image row y it returns the k = 16 smallest crossing abscissae, sorted
ascending and padded with +inf, keeping the multiplicity of tied values so
the even-odd fill parity is exact. The CUDA kernel is batched over masks:
(M, E, 2) -> (M, H, 16); see its source for the design and what bounds it.
It enumerates each edge's rows and buckets the crossings per row; a row
with more crossings than its bucket holds takes the row walk over all
edges.

`min_k_crossings_plain` is the JAX package's exact path
(ops/rasterize.py:86-104): the (H, E) candidates with the same operation
order, then the k smallest by `torch.topk`. The wrapper uses it for CPU
tensors only; on a CUDA tensor it launches the kernel or raises. The two
agree bitwise.

Non-finite vertices follow the reference's Pallas kernel: a row whose
candidates hold a NaN (a NaN or infinite vertex coordinate on an edge that
the row's predicate selects) comes out all NaN there, because its running
minimum is NaN and then retires no candidate (pallas_select.py:67-73).
The fill counts no crossing in such a row (`x >= NaN` is false).
`launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from contouring_uncertainty_torch.build import build_cuda_library

K_CROSSINGS = 16  # crossings kept per row: the kernel's compiled kK

launches = 0  # kernel launches since the last reset (plain integer)


def crossing_candidates(dense: torch.Tensor, height: int) -> torch.Tensor:
    """(M, E, 2) closed polygons -> (M, H, E) crossing abscissae per row
    (+inf for edges that do not straddle the row's pixel-centre line)."""
    p1 = torch.roll(dense, -1, dims=-2)
    x0, y0 = dense[:, None, :, 0], dense[:, None, :, 1]
    x1, y1 = p1[:, None, :, 0], p1[:, None, :, 1]
    rows = torch.arange(height, dtype=dense.dtype, device=dense.device)[:, None]
    crosses = (y0 > rows) != (y1 > rows)
    denom = y1 - y0
    safe = torch.where(denom.abs() < 1e-12, torch.ones_like(denom), denom)
    # x0 + t (x1 - x0) with t = (row - y0) / (y1 - y0), in place on the
    # (M, H, E) temporary.
    x_int = (rows - y0).div_(safe).mul_(x1 - x0).add_(x0)
    return x_int.masked_fill_(~crosses, float("inf"))


def min_k_crossings_plain(dense: torch.Tensor, height: int) -> torch.Tensor:
    """(M, E, 2) -> (M, H, 16), plain PyTorch (materialises (M, H, E));
    rows with a NaN candidate are all NaN."""
    cand = crossing_candidates(dense, height)
    neg_topk, _ = torch.topk(-cand, K_CROSSINGS, dim=-1)
    nan_row = torch.isnan(cand).any(dim=-1, keepdim=True)
    return torch.where(nan_row, float("nan"), -neg_topk)


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build_cuda_library("min_k_crossings")))
    ptr, num = ctypes.c_void_p, ctypes.c_int
    lib.cu_min_k_crossings.argtypes = [ptr, ptr, num, num, num, ptr, ptr]
    lib.cu_min_k_crossings.restype = num
    return lib


def min_k_crossings_kernel(dense: torch.Tensor, height: int,
                           overflow_rows: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: (M, E, 2) f32 CUDA tensor -> (M, H, 16).
    `overflow_rows`, a one-element int32 CUDA tensor, is incremented on the
    device by the number of rows that took the row walk."""
    global launches
    if not dense.is_cuda:
        raise ValueError(f"crossing-selection kernel takes a CUDA tensor, got {dense.device}")
    if dense.dtype != torch.float32 or dense.dim() != 3 or dense.shape[-1] != 2:
        raise ValueError(f"expected (M, E, 2) float32, got {tuple(dense.shape)} {dense.dtype}")
    dense = dense.contiguous()
    out = torch.empty((dense.shape[0], height, K_CROSSINGS), dtype=torch.float32,
                      device=dense.device)
    stream = torch.cuda.current_stream(dense.device).cuda_stream
    counter = None
    if overflow_rows is not None:
        if overflow_rows.dtype != torch.int32 or overflow_rows.device != dense.device:
            raise ValueError("overflow_rows must be an int32 tensor on the input's device")
        counter = overflow_rows.data_ptr()
    err = _library().cu_min_k_crossings(dense.data_ptr(), out.data_ptr(), dense.shape[0],
                                        dense.shape[1], height, counter, stream)
    if err != 0:
        raise RuntimeError(f"min_k_crossings kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def min_k_crossings(dense: torch.Tensor, height: int) -> torch.Tensor:
    """(M, E, 2) closed dense polygons -> (M, height, 16) smallest crossing
    abscissae per image row (+inf beyond the actual crossings). Exact."""
    if dense.device.type == "cpu":
        return min_k_crossings_plain(dense, height)
    if dense.device.type != "cuda":
        raise RuntimeError(f"no crossing-selection kernel for device {dense.device}")
    if dense.shape[0] == 0:  # a rank dealt no samples: nothing to launch
        return torch.empty((0, height, K_CROSSINGS), dtype=torch.float32, device=dense.device)
    return min_k_crossings_kernel(dense, height)
