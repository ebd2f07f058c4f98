"""ConvLayer epilogue: conv bias, channel dropout, instance norm and
LeakyReLU(0.01), forward and backward, one pass over the layer each.

`models/unet.py ConvLayer` computes conv -> [channel dropout] -> instance
norm -> LeakyReLU. On the card in f32 its convolution runs without the
bias and this module does the rest, with the two CUDA C++ kernels of
csrc/conv_epilogue.cu (bound with ctypes): one forward and one backward
launch a layer, in place of about ten PyTorch launches forward and twenty
backward, each a pass over the activations. It replaces no TPU kernel:
the JAX package leaves the chain to XLA, which fuses it.

The arithmetic, on every device:

    v = x + conv_bias, then v / keep_prob where kept, 0 where dropped
    mean = sum(v) / HW, var = max(sum(v^2) / HW - mean^2, 0), per (n, c)
    rstd = 1 / sqrt(var + 1e-5), xhat = (v - mean) * rstd
    z = xhat * weight + bias, y = z if z > 0 else 0.01 z

and its closed-form backward: gz = gy where z > 0, else 0.01 gy; per
plane S1 = sum(gz), S2 = sum(gz * xhat);

    dv = rstd * weight * (gz - S1 / HW - xhat * S2 / HW)

(the S2 term only where var was not clamped), dx = dv / keep_prob where
kept, 0 where dropped; d weight = sum over n of S2, d bias = sum of S1,
d conv_bias = the sum of dx over n, h and w (computed, as the plain chain
computes it, not taken to be 0).

`ConvEpilogue` runs the kernels on CUDA tensors only: which layers take
it is `models/unet.py ConvLayer.epilogue_route`'s choice, and everything
else here refuses what the kernels do not take. `epilogue_plain` and
`epilogue_backward_plain` are the plain version (f32, or f64 for f64
inputs), the reference the tests and chip_smoke.py hold the kernels and
autograd of the plain chain against. `epilogue_plan` lays out a launch
from H*W; `fwd_launches` and `bwd_launches` count the two kernels'
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from contouring_uncertainty_torch.build import build_cuda_library

NEG_SLOPE = 1e-2
EPSILON = 1e-5

fwd_launches = 0  # forward kernel launches since the last reset (plain integer)
bwd_launches = 0  # backward kernel launches since the last reset

# csrc/conv_epilogue.cu: threads a block (kThreads), floats a thread holds
# (kMaxElems), blocks a plane at most (kMaxCluster, the portable cluster).
THREADS = 512
MAX_ELEMS = 16
MAX_CLUSTER = 8
MAX_PLANE = THREADS * MAX_ELEMS * MAX_CLUSTER  # 65536 elements: a 256^2 plane


class EpiloguePlan(NamedTuple):
    """A launch of either kernel: `vec` floats a vector (4, or 1 where H*W
    is not a multiple of 4 or a plane not 16-byte aligned), `vecs` vectors
    a thread, `group` threads of a plane in a block, `cluster` blocks a
    plane and `planes_per_block` (THREADS // group); the kernel's grid is
    ceil(N*C / planes_per_block) * cluster blocks."""

    vec: int
    vecs: int
    group: int
    cluster: int
    planes_per_block: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def epilogue_plan(x: torch.Tensor, *others: torch.Tensor) -> EpiloguePlan:
    """The launch for an (N, C, H, W) f32 tensor in contiguous NCHW (and
    `others` of its shape, read beside it: their alignment counts). A
    plane of more than THREADS * MAX_ELEMS floats is split over a cluster
    of blocks (128^2: 2, 256^2: 8); a smaller one takes the fewest threads,
    a power of two, that hold it at MAX_ELEMS floats each, and a block
    holds THREADS / group planes. Raises TypeError on another dtype and
    ValueError on a layout the kernels do not take: another rank, a
    non-contiguous tensor, a plane over MAX_PLANE elements."""
    if x.dtype != torch.float32:
        raise TypeError(f"the conv epilogue kernels take f32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"the conv epilogue kernels take contiguous (N, C, H, W) tensors, got "
                         f"shape {tuple(x.shape)}, strides {x.stride()}")
    hw = x.shape[2] * x.shape[3]
    if hw > MAX_PLANE:
        raise ValueError(f"the conv epilogue kernels take planes of at most {MAX_PLANE} "
                         f"elements, got {x.shape[2]}x{x.shape[3]}")
    vec = 4 if hw % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, *others)) else 1
    n_vec = max(hw // vec, 1)
    max_vecs = MAX_ELEMS // vec
    if n_vec > THREADS * max_vecs:
        group, vecs = THREADS, max_vecs
        cluster = -(-n_vec // (THREADS * max_vecs))
    else:
        group = _pow2_at_least(-(-n_vec // max_vecs))
        vecs = _pow2_at_least(-(-n_vec // group))
        cluster = 1
    return EpiloguePlan(vec, vecs, group, cluster, THREADS // group)


def _dropped(x, conv_bias, keep, keep_prob):
    """x + conv_bias, then / keep_prob where kept and 0 where dropped."""
    v = x if conv_bias is None else x + conv_bias[:, None, None].to(x.dtype)
    if keep is None:
        return v
    return torch.where(keep[:, :, None, None], v / keep_prob,
                       torch.zeros((), dtype=v.dtype, device=v.device))


def epilogue_plain(x: torch.Tensor, conv_bias: Optional[torch.Tensor],
                   keep: Optional[torch.Tensor], keep_prob: float, weight: torch.Tensor,
                   bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward of the epilogue in plain PyTorch, in x's dtype (f32 or
    f64): (N, C, H, W) conv output without bias, (C,) conv bias or None,
    (N, C) bool keep mask or None (no dropout), (C,) norm weight and bias
    -> y and the (3, N*C) statistics (mean, rstd, 1 where var was not
    clamped)."""
    v = _dropped(x, conv_bias, keep, keep_prob)
    mean = v.mean(dim=(2, 3))
    raw = (v * v).mean(dim=(2, 3)) - mean * mean
    rstd = torch.rsqrt(torch.clamp(raw, min=0.0) + EPSILON)
    z = ((v - mean[..., None, None]) * rstd[..., None, None] * weight.to(x.dtype)[:, None, None]
         + bias.to(x.dtype)[:, None, None])
    y = torch.where(z > 0, z, z * NEG_SLOPE)
    stats = torch.stack([mean, rstd, (raw >= 0).to(x.dtype)]).reshape(3, -1)
    return y, stats


def epilogue_backward_plain(x: torch.Tensor, conv_bias: Optional[torch.Tensor],
                            keep: Optional[torch.Tensor], keep_prob: float,
                            weight: torch.Tensor, bias: torch.Tensor, stats: torch.Tensor,
                            gy: torch.Tensor, sides: Optional[torch.Tensor] = None):
    """The closed-form backward in plain PyTorch, in x's dtype: the
    forward's inputs, its statistics and the gradient gy of y -> (dx,
    d conv_bias, d weight, d bias). `sides` (bool, y's shape) replaces
    z > 0 as the side of each kink: an f64 evaluation on the kink sides an
    f32 forward chose."""
    n, c, h, w = x.shape
    v = _dropped(x, conv_bias, keep, keep_prob)
    mean, rstd, full = (s.reshape(n, c, 1, 1).to(x.dtype) for s in stats)
    xhat = (v - mean) * rstd
    wc = weight.to(x.dtype)[:, None, None]
    if sides is None:
        sides = xhat * wc + bias.to(x.dtype)[:, None, None] > 0
    gz = torch.where(sides, gy, gy * NEG_SLOPE)
    s1 = gz.sum(dim=(2, 3), keepdim=True)
    s2 = (gz * xhat).sum(dim=(2, 3), keepdim=True)
    dx = rstd * wc * (gz - s1 / (h * w) - xhat * (full * s2 / (h * w)))
    if keep is not None:
        dx = torch.where(keep[:, :, None, None], dx / keep_prob,
                         torch.zeros((), dtype=dx.dtype, device=dx.device))
    return dx, dx.sum(dim=(0, 2, 3)), s2.sum(dim=(0, 2, 3)), s1.sum(dim=(0, 2, 3))


@functools.cache
def _cuda_library():
    lib = ctypes.CDLL(str(build_cuda_library("conv_epilogue")))
    ptr, num, big = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cu_conv_epilogue.argtypes = [num, ptr, ptr, ptr, ctypes.c_float, ptr, ptr, ptr, ptr, ptr,
                                     ptr, big, num, num, num, num, num, num, ptr]
    lib.cu_conv_epilogue.restype = num
    return lib


def _check_params(x, *params):
    if x.device.type != "cuda":
        raise ValueError(f"the conv epilogue kernels take CUDA tensors, got one on {x.device}")
    for p in params:
        if p is not None and (p.dtype != torch.float32 or p.device != x.device
                              or not p.is_contiguous()):
            raise ValueError(f"the conv epilogue kernels take contiguous f32 parameters on "
                             f"{x.device}, got {p.dtype} on {p.device}")


def _launch(backward: bool, x, conv_bias, keep, keep_prob, weight, bias, gy, out, stats, part,
            plan: EpiloguePlan) -> None:
    n, c, h, w = x.shape
    if keep is not None and (keep.dtype != torch.bool or keep.shape != (n, c)
                             or not keep.is_contiguous()):
        raise ValueError(f"the keep mask is a contiguous (N, C) bool tensor, got {keep.dtype} "
                         f"{tuple(keep.shape)}")
    err = _cuda_library().cu_conv_epilogue(
        int(backward), x.data_ptr(), None if conv_bias is None else conv_bias.data_ptr(),
        None if keep is None else keep.data_ptr(), float(keep_prob), weight.data_ptr(),
        bias.data_ptr(), None if gy is None else gy.data_ptr(), out.data_ptr(), stats.data_ptr(),
        None if part is None else part.data_ptr(), n * c, c, h * w, plan.vec, plan.vecs,
        plan.group, plan.cluster, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv epilogue {'backward' if backward else 'forward'} kernel launch "
                           f"failed: CUDA error {err}")


def epilogue_cuda(x, conv_bias, keep, keep_prob, weight, bias):
    """The forward kernel on a CUDA tensor: (y, stats) as `epilogue_plain`."""
    global fwd_launches
    plan = epilogue_plan(x)
    _check_params(x, conv_bias, weight, bias)
    y = torch.empty_like(x)
    stats = torch.empty((3, x.shape[0] * x.shape[1]), dtype=torch.float32, device=x.device)
    if x.numel():
        _launch(False, x, conv_bias, keep, keep_prob, weight, bias, None, y, stats, None, plan)
        fwd_launches += 1
    return y, stats


def epilogue_backward_cuda(x, conv_bias, keep, keep_prob, weight, bias, stats, gy):
    """The backward kernel on CUDA tensors: (dx, d conv_bias, d weight,
    d bias) as `epilogue_backward_plain`; the sums over n (and over the
    cluster's blocks for the conv bias) are taken here."""
    global bwd_launches
    if gy.shape != x.shape or gy.dtype != torch.float32 or not gy.is_contiguous():
        raise ValueError(f"gy must be a contiguous f32 tensor of x's shape {tuple(x.shape)}, "
                         f"got {gy.dtype} {tuple(gy.shape)}, strides {gy.stride()}")
    plan = epilogue_plan(x, gy)
    _check_params(x, conv_bias, weight, bias, stats)
    n, c = x.shape[:2]
    dx = torch.empty_like(x)
    part = torch.empty((2 + plan.cluster, n, c), dtype=torch.float32, device=x.device)
    if x.numel():
        _launch(True, x, conv_bias, keep, keep_prob, weight, bias, gy, dx, stats, part, plan)
        bwd_launches += 1
    sums = part.sum(dim=1)
    return dx, sums[2:].sum(dim=0), sums[0], sums[1]


class ConvEpilogue(torch.autograd.Function):
    """(N, C, H, W) CUDA conv output without bias -> the ConvLayer's
    output, by the kernels. Saves x and the (3, N*C) statistics for the
    backward."""

    @staticmethod
    def forward(ctx, x, conv_bias, keep, keep_prob, weight, bias):
        x = x.contiguous()
        y, stats = epilogue_cuda(x, conv_bias, keep, keep_prob, weight, bias)
        ctx.save_for_backward(x, conv_bias, keep, weight, bias, stats)
        ctx.keep_prob = keep_prob
        return y

    @staticmethod
    def backward(ctx, gy):
        x, conv_bias, keep, weight, bias, stats = ctx.saved_tensors
        dx, dcb, dw, db = epilogue_backward_cuda(x, conv_bias, keep, ctx.keep_prob, weight,
                                                 bias, stats, gy.contiguous())
        return dx, None if conv_bias is None else dcb, None, None, dw, db


def conv_epilogue(x: torch.Tensor, conv_bias: Optional[torch.Tensor],
                  keep: Optional[torch.Tensor], keep_prob: float, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """The ConvLayer's output from its convolution's output without bias
    (N, C, H, W), the conv bias (C,) or None, the (N, C) bool keep mask of
    the channel dropout or None, its keep probability, and the instance
    norm's weight and bias (C,), all on one CUDA device; differentiable."""
    return ConvEpilogue.apply(x, conv_bias, keep, keep_prob, weight, bias)
