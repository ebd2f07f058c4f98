"""The 1x1 convolution whose weight gradient is a hand-written kernel.

For a 1x1 convolution with zero padding and stride (sh, sw), the weight
gradient is a matrix product over the output's pixels:

    dW[co, ci] = sum over n, i, j of dY[n, co, i, j] * X[n, ci, i*sh, j*sw]

Its output is small and its reduction huge (DeepLabV3's first stage: 256 x
64 over 131,072 pixels at batch 32), the shape cuDNN's weight gradient
runs worst. On the card, `wgrad` runs the split-K CUDA C++ kernel of
csrc/conv1x1_wgrad.cu (bound with ctypes): the reduction cut into
`wgrad_plan`'s ranges, each range's partial product in f32 with f32
fused multiply-adds, then the ranges summed in index order (a second
launch), so the result is the same bits from run to run. It reads dY and
X where they lie (X through the stride, as a strided view), with no
layout copy. `wgrad_plain` is the plain version (an einsum over n and the
pixels, in the inputs' dtype), the reference the tests and chip_smoke.py
hold the kernel against; `wgrad` takes it for CPU tensors only. The
kernel replaces no TPU kernel: the JAX package leaves this gradient to
XLA.

`Conv1x1` is the convolution as an autograd Function: its forward is
`F.conv2d`, its backward the input's gradient by cuDNN's data gradient
alone (`aten.convolution_backward` with output mask (True, False,
False)), the weight's by `wgrad`, the bias's the sum of dY over
(0, 2, 3). Which convolutions take it is `models/layers.py wgrad_route`'s
choice alone. `launches` counts the kernel's launches (its reduce pass
not included), `reduce_launches` the reduce pass's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from contouring_uncertainty_torch.build import build_cuda_library

launches = 0  # split-K kernel launches in this process (plain integer)
reduce_launches = 0  # reduce pass launches in this process

SLAB = 16  # pixels a slab (csrc/conv1x1_wgrad.cu kBK)
SIDES = (32, 64, 128, 256)  # output tile sides the kernel is built for
TILE = 128 * 128  # outputs a tile at most: a thread's 64 accumulators


class WgradPlan(NamedTuple):
    """A launch: `bm` x `bn` output tiles (Co x Ci), `splits` ranges of
    `chunk` pixels (a multiple of SLAB; the last range may be shorter)."""

    bm: int
    bn: int
    splits: int
    chunk: int


def _side(c: int) -> int:
    return next((s for s in SIDES if c <= s), SIDES[-1])


@functools.cache
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def blocks_per_sm(bm: int, bn: int, tiles: int) -> int:
    """Blocks a launch gives each SM: one where the output is at most four
    full tiles (DeepLabV3's first-stage 1x1s: each split then runs twice
    the pixels alone on its SM, and the splits' partial sums halve), two
    elsewhere (measured on an H100, PERF.md)."""
    return 1 if bm * bn == TILE and tiles <= 4 else 2


def wgrad_plan(co: int, ci: int, np_: int, sms: int) -> WgradPlan:
    """The launch for Co x Ci outputs over `np_` = N*Ho*Wo pixels on a
    device of `sms` SMs, from the shape alone: the smallest tile sides of
    SIDES that hold Co and Ci (256 above), the larger halved while the tile
    holds more than TILE outputs (128 x 128, 256 x 64, 32 x 256, ...); then
    as many splits as bring tiles x splits to `blocks_per_sm` x `sms`
    without passing it (at least one, at most one a slab), each an equal
    whole number of slabs."""
    if min(co, ci, np_) < 1:
        raise ValueError(f"a 1x1 weight gradient needs Co, Ci and N*Ho*Wo >= 1, got "
                         f"{(co, ci, np_)}")
    bm, bn = _side(co), _side(ci)
    while bm * bn > TILE:
        bm, bn = (bm // 2, bn) if bm >= bn else (bm, bn // 2)
    tiles = -(-co // bm) * -(-ci // bn)
    slabs = -(-np_ // SLAB)
    splits = max(1, min(blocks_per_sm(bm, bn, tiles) * sms // tiles, slabs))
    chunk = -(-slabs // splits) * SLAB
    return WgradPlan(bm, bn, -(-np_ // chunk), chunk)


def bound_seconds(co: int, ci: int, np_: int, flops_per_s: float = 67e12,
                  bytes_per_s: float = 3.35e12) -> float:
    """The least time an H100 SXM could take: the larger of 2*Co*Ci*NP
    operations at the f32 rate and 4*(Co+Ci)*NP bytes (each operand read
    once) at the memory's rate."""
    return max(2.0 * co * ci * np_ / flops_per_s, 4.0 * (co + ci) * np_ / bytes_per_s)


def strided_input(x: torch.Tensor, stride) -> torch.Tensor:
    """X as the 1x1 convolution's output pixels see it: a view through the
    stride (no copy)."""
    return x[:, :, ::stride[0], ::stride[1]]


def wgrad_plain(gy: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """dW (Co, Ci) in plain PyTorch, in the inputs' dtype: dY (N, Co, Ho,
    Wo) and X through the stride (N, Ci, Ho, Wo), summed over n and the
    pixels."""
    n, co = gy.shape[:2]
    return torch.einsum("ncp,nkp->ck", gy.reshape(n, co, -1), xs.reshape(n, xs.shape[1], -1))


@functools.cache
def _cuda_library():
    lib = ctypes.CDLL(str(build_cuda_library("conv1x1_wgrad")))
    ptr, num, big = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cu_conv1x1_wgrad.argtypes = [ptr, big, big, big, big, ptr, big, big, big, big, ptr, ptr,
                                     num, num, num, num, num, num, num, num, big, ptr]
    lib.cu_conv1x1_wgrad.restype = num
    return lib


def _check_shapes(gy: torch.Tensor, xs: torch.Tensor) -> None:
    if gy.dim() != 4 or xs.dim() != 4 or gy.shape[0] != xs.shape[0] \
            or gy.shape[2:] != xs.shape[2:]:
        raise ValueError(f"dY (N, Co, Ho, Wo) and X through the stride (N, Ci, Ho, Wo) must "
                         f"share N, Ho and Wo, got {tuple(gy.shape)} and {tuple(xs.shape)}")


def _check(gy: torch.Tensor, xs: torch.Tensor) -> None:
    if gy.device.type != "cuda" or xs.device != gy.device:
        raise ValueError(f"the 1x1 weight gradient kernel takes CUDA tensors on one device, got "
                         f"{gy.device} and {xs.device}")
    if gy.dtype != torch.float32 or xs.dtype != torch.float32:
        raise TypeError(f"the 1x1 weight gradient kernel takes f32, got {gy.dtype} and "
                        f"{xs.dtype}")
    _check_shapes(gy, xs)


def wgrad_cuda(gy: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors: dW (Co, Ci) as `wgrad_plain`, f32."""
    global launches, reduce_launches
    _check(gy, xs)
    n, co, ho, wo = gy.shape
    ci = xs.shape[1]
    out = torch.empty((co, ci), dtype=torch.float32, device=gy.device)
    if n * ho * wo == 0:
        return out.zero_()
    plan = wgrad_plan(co, ci, n * ho * wo, sm_count(gy.device))
    part = None
    if plan.splits > 1:
        part = torch.empty((plan.splits, co, ci), dtype=torch.float32, device=gy.device)
    err = _cuda_library().cu_conv1x1_wgrad(
        gy.data_ptr(), *gy.stride(), xs.data_ptr(), *xs.stride(),
        None if part is None else part.data_ptr(), out.data_ptr(), co, ci, n, ho, wo,
        plan.bm, plan.bn, plan.splits, plan.chunk,
        torch.cuda.current_stream(gy.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"1x1 weight gradient kernel launch failed: CUDA error {err}")
    launches += 1
    reduce_launches += plan.splits > 1
    return out


def wgrad(gy: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """dW (Co, Ci) of a 1x1 convolution from dY (N, Co, Ho, Wo) and X
    through the stride (N, Ci, Ho, Wo): the kernel on CUDA tensors (or a
    raise), the plain version on CPU tensors."""
    if gy.device.type == "cpu":
        _check_shapes(gy, xs)
        return wgrad_plain(gy, xs)
    return wgrad_cuda(gy, xs)


class Conv1x1(torch.autograd.Function):
    """F.conv2d(x, weight, bias, stride, 0, dilation) of a (Co, Ci, 1, 1)
    weight (stride and dilation tuples), its weight gradient by `wgrad`.
    Saves x and the weight, as autograd's convolution does."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, dilation):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.dilation = stride, dilation
        ctx.bias_sizes = None if bias is None else list(bias.shape)
        return F.conv2d(x, weight, bias, stride, 0, dilation)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                gy, x, weight, ctx.bias_sizes, list(ctx.stride), [0, 0], list(ctx.dilation),
                False, [0, 0], 1, [True, False, False])[0]
        if ctx.needs_input_grad[1]:
            dw = wgrad(gy, strided_input(x, ctx.stride)).reshape(weight.shape)
        if ctx.bias_sizes is not None and ctx.needs_input_grad[2]:
            db = gy.sum(dim=(0, 2, 3))
        return dx, dw, db, None, None
