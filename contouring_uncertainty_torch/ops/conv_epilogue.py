"""Norm chains: what follows a convolution up to the next one's input,
forward and backward, one pass over the layer each.

The conv epilogue: conv bias, channel dropout, instance norm and an
activation (LeakyReLU(0.01), ReLU or none). `models/layers.py conv_norm`
computes conv -> [channel dropout] -> norm -> activation: the UNet's
ConvLayer with LeakyReLU, DeepLabV3's chains with ReLU or none (no conv
bias, no dropout). On the card in f32 the convolution runs without its
bias and this module does the rest, with the CUDA C++ kernels of
csrc/conv_epilogue.cu (bound with ctypes): one forward and one backward
launch a layer, in place of about ten PyTorch launches forward and twenty
backward, each a pass over the activations. The activation is the
kernels' template parameter, chosen here. The arithmetic, on every device:

    v = x + conv_bias, then v / keep_prob where kept, 0 where dropped
    mean = sum(v) / HW, var = max(sum(v^2) / HW - mean^2, 0), per (n, c)
    rstd = 1 / sqrt(var + 1e-5), xhat = (v - mean) * rstd
    z = xhat * weight + bias, y = act(z)

and its closed-form backward: gz = gy * act'(z) (LeakyReLU: 1 where
z > 0, else 0.01; ReLU: 1 or 0; none: 1); per plane S1 = sum(gz),
S2 = sum(gz * xhat);

    dv = rstd * weight * (gz - S1 / HW - xhat * S2 / HW)

(the S2 term only where var was not clamped), dx = dv / keep_prob where
kept, 0 where dropped; d weight = sum over n of S2, d bias = sum of S1,
d conv_bias = the sum of dx over n, h and w (computed, as the plain chain
computes it, not taken to be 0).

The norm tail: a DeepLabV3 bottleneck's last norm, its channel dropout
after the norm, the residual add and the ReLU, from the convolution's
output a and the residual r:

    z = xhat * weight + bias (a's statistics as above)
    y = relu(z / keep_prob where kept, 0 where dropped, + r)

backward: gz = gy where y > 0, else 0 (r's gradient); gn = gz / keep_prob
where kept, else 0; da = the closed form above of gn; d weight, d bias the
sums of S2 and S1 of gn.

The Functions (`ConvEpilogue`, `NormTail`) run the kernels on CUDA tensors
only: which chains take them is `models/layers.py chain_route`'s choice
alone (`conv_norm` and `conv_norm_tail` call it), and everything else here
refuses what the kernels do not take. `epilogue_plain`,
`epilogue_backward_plain`, `tail_plain` and `tail_backward_plain` are the
plain versions (f32, or f64 for f64 inputs), the reference the tests and
chip_smoke.py hold the kernels and autograd of the plain chains against.
They replace no TPU kernel: the JAX package leaves the chains to XLA, which
fuses them. `epilogue_plan` lays out a launch of either pair from H*W;
`fwd_launches` and `bwd_launches` count the epilogue kernels' launches,
`tail_fwd_launches` and `tail_bwd_launches` the tail's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from contouring_uncertainty_torch.build import build_cuda_library

NEG_SLOPE = 1e-2
EPSILON = 1e-5

fwd_launches = 0  # epilogue forward kernel launches since the last reset (plain integer)
bwd_launches = 0  # epilogue backward kernel launches since the last reset
tail_fwd_launches = 0  # norm tail forward kernel launches since the last reset
tail_bwd_launches = 0  # norm tail backward kernel launches since the last reset

# The epilogue's activations -> csrc/conv_epilogue.cu `Act`.
ACTIVATIONS = {"leaky_relu": 0, "relu": 1, None: 2}

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


def _activation(activation):
    if activation not in ACTIVATIONS:
        raise ValueError(f"the conv epilogue's activation is one of {list(ACTIVATIONS)}, "
                         f"got {activation!r}")
    return activation


def _normed(v, weight, bias):
    """The norm of v's planes -> z and the (3, N*C) statistics (mean, rstd,
    1 where var was not clamped)."""
    mean = v.mean(dim=(2, 3))
    raw = (v * v).mean(dim=(2, 3)) - mean * mean
    rstd = torch.rsqrt(torch.clamp(raw, min=0.0) + EPSILON)
    z = ((v - mean[..., None, None]) * rstd[..., None, None] * weight.to(v.dtype)[:, None, None]
         + bias.to(v.dtype)[:, None, None])
    return z, torch.stack([mean, rstd, (raw >= 0).to(v.dtype)]).reshape(3, -1)


def _norm_backward(v, weight, stats, gz):
    """The norm's closed-form backward from v, its statistics and the
    gradient gz of z -> (dv, per-plane S2, per-plane S1)."""
    n, c, h, w = v.shape
    mean, rstd, full = (s.reshape(n, c, 1, 1).to(v.dtype) for s in stats)
    xhat = (v - mean) * rstd
    s1 = gz.sum(dim=(2, 3), keepdim=True)
    s2 = (gz * xhat).sum(dim=(2, 3), keepdim=True)
    dv = rstd * weight.to(v.dtype)[:, None, None] * (gz - s1 / (h * w)
                                                     - xhat * (full * s2 / (h * w)))
    return dv, s2, s1


def epilogue_plain(x: torch.Tensor, conv_bias: Optional[torch.Tensor],
                   keep: Optional[torch.Tensor], keep_prob: float, weight: torch.Tensor,
                   bias: torch.Tensor, activation: Optional[str] = "leaky_relu"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward of the epilogue in plain PyTorch, in x's dtype (f32 or
    f64): (N, C, H, W) conv output without bias, (C,) conv bias or None,
    (N, C) bool keep mask or None (no dropout), (C,) norm weight and bias,
    the activation ("leaky_relu", "relu" or None) -> y and the (3, N*C)
    statistics (mean, rstd, 1 where var was not clamped)."""
    activation = _activation(activation)
    z, stats = _normed(_dropped(x, conv_bias, keep, keep_prob), weight, bias)
    if activation == "leaky_relu":
        return torch.where(z > 0, z, z * NEG_SLOPE), stats
    if activation == "relu":
        return torch.where(z > 0, z, torch.zeros((), dtype=z.dtype, device=z.device)), stats
    return z, stats


def _kept(t, keep, keep_prob):
    """t / keep_prob where the (N, C) mask keeps the plane, 0 where not."""
    if keep is None:
        return t
    return torch.where(keep[:, :, None, None], t / keep_prob,
                       torch.zeros((), dtype=t.dtype, device=t.device))


def epilogue_backward_plain(x: torch.Tensor, conv_bias: Optional[torch.Tensor],
                            keep: Optional[torch.Tensor], keep_prob: float,
                            weight: torch.Tensor, bias: torch.Tensor, stats: torch.Tensor,
                            gy: torch.Tensor, sides: Optional[torch.Tensor] = None,
                            activation: Optional[str] = "leaky_relu"):
    """The closed-form backward in plain PyTorch, in x's dtype: the
    forward's inputs, its statistics and the gradient gy of y -> (dx,
    d conv_bias, d weight, d bias). `sides` (bool, y's shape) replaces
    z > 0 as the side of each kink: an f64 evaluation on the kink sides an
    f32 forward chose."""
    activation = _activation(activation)
    n, c = x.shape[:2]
    v = _dropped(x, conv_bias, keep, keep_prob)
    if activation is None:
        gz = gy
    else:
        if sides is None:
            mean, rstd = (s.reshape(n, c, 1, 1).to(x.dtype) for s in stats[:2])
            sides = ((v - mean) * rstd * weight.to(x.dtype)[:, None, None]
                     + bias.to(x.dtype)[:, None, None] > 0)
        slope = NEG_SLOPE if activation == "leaky_relu" else 0.0
        gz = torch.where(sides, gy, gy * slope)
    dv, s2, s1 = _norm_backward(v, weight, stats, gz)
    dx = _kept(dv, keep, keep_prob)
    return dx, dx.sum(dim=(0, 2, 3)), s2.sum(dim=(0, 2, 3)), s1.sum(dim=(0, 2, 3))


def tail_plain(a: torch.Tensor, keep: Optional[torch.Tensor], keep_prob: float,
               weight: torch.Tensor, bias: torch.Tensor, r: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward of the norm tail in plain PyTorch, in a's dtype: (N, C, H, W)
    conv output, (N, C) bool keep mask of the dropout after the norm or
    None, its keep probability, (C,) norm weight and bias, the residual r
    of a's shape -> y and the (3, N*C) statistics."""
    z, stats = _normed(a, weight, bias)
    y = _kept(z, keep, keep_prob) + r.to(a.dtype)
    return torch.where(y > 0, y, torch.zeros((), dtype=y.dtype, device=y.device)), stats


def tail_backward_plain(a: torch.Tensor, keep: Optional[torch.Tensor], keep_prob: float,
                        weight: torch.Tensor, bias: torch.Tensor, stats: torch.Tensor,
                        y: torch.Tensor, gy: torch.Tensor):
    """The norm tail's closed-form backward in plain PyTorch, in a's dtype:
    the forward's inputs, its statistics, its output y and the gradient gy
    of y -> (da, d weight, d bias, dr)."""
    gz = torch.where(y > 0, gy, torch.zeros((), dtype=gy.dtype, device=gy.device))
    da, s2, s1 = _norm_backward(a, weight, stats, _kept(gz, keep, keep_prob))
    return da, s2.sum(dim=(0, 2, 3)), s1.sum(dim=(0, 2, 3)), gz


@functools.cache
def _cuda_library():
    lib = ctypes.CDLL(str(build_cuda_library("conv_epilogue")))
    ptr, num, big, flt = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.cu_conv_epilogue.argtypes = [num, num, ptr, ptr, ptr, flt, ptr, ptr, ptr, ptr, ptr,
                                     ptr, big, num, num, num, num, num, num, ptr]
    lib.cu_conv_epilogue.restype = num
    lib.cu_norm_tail.argtypes = [num, ptr, ptr, ptr, flt, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                 big, num, num, num, num, num, num, ptr]
    lib.cu_norm_tail.restype = num
    return lib


def _check_params(x, *params):
    if x.device.type != "cuda":
        raise ValueError(f"the conv epilogue kernels take CUDA tensors, got one on {x.device}")
    for p in params:
        if p is not None and (p.dtype != torch.float32 or p.device != x.device
                              or not p.is_contiguous()):
            raise ValueError(f"the conv epilogue kernels take contiguous f32 parameters on "
                             f"{x.device}, got {p.dtype} on {p.device}")


def _check_keep(x, keep):
    n, c = x.shape[:2]
    if keep is not None and (keep.dtype != torch.bool or keep.shape != (n, c)
                             or not keep.is_contiguous()):
        raise ValueError(f"the keep mask is a contiguous (N, C) bool tensor, got {keep.dtype} "
                         f"{tuple(keep.shape)}")


def _check_like(t, x, name="gy"):
    if t.shape != x.shape or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous f32 tensor of x's shape {tuple(x.shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}, strides {t.stride()}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _launch(backward: bool, x, conv_bias, keep, keep_prob, weight, bias, gy, out, stats, part,
            plan: EpiloguePlan, activation) -> None:
    n, c, h, w = x.shape
    _check_keep(x, keep)
    err = _cuda_library().cu_conv_epilogue(
        int(backward), ACTIVATIONS[activation], x.data_ptr(), _ptr(conv_bias), _ptr(keep),
        float(keep_prob), weight.data_ptr(), bias.data_ptr(), _ptr(gy), out.data_ptr(),
        stats.data_ptr(), _ptr(part), n * c, c, h * w, plan.vec, plan.vecs, plan.group,
        plan.cluster, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, f"conv epilogue {'backward' if backward else 'forward'}")


def epilogue_cuda(x, conv_bias, keep, keep_prob, weight, bias, activation="leaky_relu"):
    """The forward kernel on a CUDA tensor: (y, stats) as `epilogue_plain`."""
    global fwd_launches
    activation = _activation(activation)
    plan = epilogue_plan(x)
    _check_params(x, conv_bias, weight, bias)
    y = torch.empty_like(x)
    stats = torch.empty((3, x.shape[0] * x.shape[1]), dtype=torch.float32, device=x.device)
    if x.numel():
        _launch(False, x, conv_bias, keep, keep_prob, weight, bias, None, y, stats, None, plan,
                activation)
        fwd_launches += 1
    return y, stats


def epilogue_backward_cuda(x, conv_bias, keep, keep_prob, weight, bias, stats, gy,
                           activation="leaky_relu"):
    """The backward kernel on CUDA tensors: (dx, d conv_bias, d weight,
    d bias) as `epilogue_backward_plain`; the sums over n (and over the
    cluster's blocks for the conv bias) are taken here."""
    global bwd_launches
    activation = _activation(activation)
    _check_like(gy, x)
    plan = epilogue_plan(x, gy)
    _check_params(x, conv_bias, weight, bias, stats)
    n, c = x.shape[:2]
    dx = torch.empty_like(x)
    rows = 2 + (plan.cluster if conv_bias is not None else 0)
    part = torch.empty((rows, n, c), dtype=torch.float32, device=x.device)
    if x.numel():
        _launch(True, x, conv_bias, keep, keep_prob, weight, bias, gy, dx, stats, part, plan,
                activation)
        bwd_launches += 1
    sums = part.sum(dim=1)
    return dx, sums[2:].sum(dim=0), sums[0], sums[1]


def _launch_tail(backward: bool, a, res, keep, keep_prob, weight, bias, gy, out, out2, stats,
                 part, plan: EpiloguePlan) -> None:
    n, c, h, w = a.shape
    _check_keep(a, keep)
    err = _cuda_library().cu_norm_tail(
        int(backward), a.data_ptr(), res.data_ptr(), _ptr(keep), float(keep_prob),
        weight.data_ptr(), bias.data_ptr(), _ptr(gy), out.data_ptr(), _ptr(out2),
        stats.data_ptr(), _ptr(part), n * c, c, h * w, plan.vec, plan.vecs, plan.group,
        plan.cluster, torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(err, f"norm tail {'backward' if backward else 'forward'}")


def tail_cuda(a, keep, keep_prob, weight, bias, r):
    """The norm tail's forward kernel on CUDA tensors: (y, stats) as
    `tail_plain`."""
    global tail_fwd_launches
    _check_like(r, a, "the residual")
    plan = epilogue_plan(a, r)
    _check_params(a, weight, bias)
    y = torch.empty_like(a)
    stats = torch.empty((3, a.shape[0] * a.shape[1]), dtype=torch.float32, device=a.device)
    if a.numel():
        _launch_tail(False, a, r, keep, keep_prob, weight, bias, None, y, None, stats, None, plan)
        tail_fwd_launches += 1
    return y, stats


def tail_backward_cuda(a, keep, keep_prob, weight, bias, stats, y, gy):
    """The norm tail's backward kernel on CUDA tensors: (da, d weight,
    d bias, dr) as `tail_backward_plain`; the sums over n are taken here."""
    global tail_bwd_launches
    _check_like(gy, a)
    _check_like(y, a, "y")
    plan = epilogue_plan(a, y, gy)
    _check_params(a, weight, bias, stats)
    n, c = a.shape[:2]
    da, dr = torch.empty_like(a), torch.empty_like(a)
    part = torch.empty((2, n, c), dtype=torch.float32, device=a.device)
    if a.numel():
        _launch_tail(True, a, y, keep, keep_prob, weight, bias, gy, da, dr, stats, part, plan)
        tail_bwd_launches += 1
    sums = part.sum(dim=1)
    return da, sums[0], sums[1], dr


class ConvEpilogue(torch.autograd.Function):
    """(N, C, H, W) CUDA conv output without bias -> the layer's output
    after its norm and activation, by the kernels. Saves x and the (3, N*C)
    statistics for the backward."""

    @staticmethod
    def forward(ctx, x, conv_bias, keep, keep_prob, weight, bias, activation):
        x = x.contiguous()
        y, stats = epilogue_cuda(x, conv_bias, keep, keep_prob, weight, bias, activation)
        ctx.save_for_backward(x, conv_bias, keep, weight, bias, stats)
        ctx.keep_prob = keep_prob
        ctx.activation = activation
        return y

    @staticmethod
    def backward(ctx, gy):
        x, conv_bias, keep, weight, bias, stats = ctx.saved_tensors
        dx, dcb, dw, db = epilogue_backward_cuda(x, conv_bias, keep, ctx.keep_prob, weight,
                                                 bias, stats, gy.contiguous(),
                                                 activation=ctx.activation)
        return dx, None if conv_bias is None else dcb, None, None, dw, db, None


def conv_epilogue(x: torch.Tensor, conv_bias: Optional[torch.Tensor],
                  keep: Optional[torch.Tensor], keep_prob: float, weight: torch.Tensor,
                  bias: torch.Tensor, activation: Optional[str] = "leaky_relu") -> torch.Tensor:
    """The layer's output from its convolution's output without bias
    (N, C, H, W), the conv bias (C,) or None, the (N, C) bool keep mask of
    the channel dropout or None, its keep probability, the norm's weight
    and bias (C,), all on one CUDA device, and the activation
    ("leaky_relu", "relu" or None); differentiable."""
    return ConvEpilogue.apply(x, conv_bias, keep, keep_prob, weight, bias, activation)


class NormTail(torch.autograd.Function):
    """(N, C, H, W) CUDA conv output and residual -> the bottleneck's
    output, by the tail kernels. Saves a, the statistics and the output y
    (which the next convolution saves too) for the backward."""

    @staticmethod
    def forward(ctx, a, keep, keep_prob, weight, bias, r):
        a = a.contiguous()
        y, stats = tail_cuda(a, keep, keep_prob, weight, bias, r.contiguous())
        ctx.save_for_backward(a, keep, weight, bias, stats, y)
        ctx.keep_prob = keep_prob
        return y

    @staticmethod
    def backward(ctx, gy):
        a, keep, weight, bias, stats, y = ctx.saved_tensors
        da, dw, db, dr = tail_backward_cuda(a, keep, ctx.keep_prob, weight, bias, stats, y,
                                            gy.contiguous())
        return da, None, None, dw, db, dr


def norm_tail(a: torch.Tensor, keep: Optional[torch.Tensor], keep_prob: float,
              weight: torch.Tensor, bias: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """relu(dropout(norm(a)) + r) from the convolution's output a
    (N, C, H, W), the (N, C) bool keep mask of the dropout after the norm
    or None, its keep probability, the norm's weight and bias (C,) and the
    residual r of a's shape, all on one CUDA device; differentiable."""
    return NormTail.apply(a, keep, keep_prob, weight, bias, r)
