"""The backbones' shared layers in PyTorch (NCHW) and the one route of
their fused norm chains.

Conv, ConvTranspose, Dense and InstanceNorm with flax's initialisers and
padding: f32 parameters, convolutions in `dtype` (weights cast per call),
norm statistics in f32 (f64 in an f64 model). Channel dropout draws its
masks from an explicit `torch.Generator` (rng.py) in execution order.

A norm chain is what follows a convolution up to the next one's input:
`conv_norm` (conv -> [channel dropout] -> norm -> activation) or
`conv_norm_tail` (a bottleneck's conv -> norm -> [dropout] -> + residual ->
ReLU). `chain_route` alone decides whether a chain runs on the kernels of
ops/conv_epilogue.py or op by op; both branches draw the same masks in the
same order. `wgrad_route` alone decides whether a 1x1 convolution's weight
gradient runs on the kernel of ops/conv1x1_wgrad.py or in cuDNN.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from contouring_uncertainty_torch.ops import conv1x1_wgrad, conv_epilogue
from contouring_uncertainty_torch.rng import draw_uniform

NEG_SLOPE = conv_epilogue.NEG_SLOPE  # the LeakyReLU's, on either route
# flax variance_scaling(2 / (1 + 0.01^2), "fan_in", "truncated_normal"):
# N(0, sqrt(scale / fan_in)) truncated at +-2 std, std corrected by the
# truncation factor.
_KAIMING_SCALE = 2.0 / (1.0 + 0.01 ** 2)
_TRUNC_STD = 0.87962566103423978


def _kaiming_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator],
              scale: float = _KAIMING_SCALE):
    """flax variance_scaling(scale, "fan_in", "truncated_normal"); scale 1
    is flax's default (lecun) initializer."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def torch_padding(kernel_size) -> tuple:
    """Symmetric padding (k//2, k//2) per spatial dim (not XLA's "SAME")."""
    return tuple(k // 2 for k in kernel_size)


def same_padding(size, kernel_size, stride, dilation) -> list:
    """XLA's "SAME" padding of each spatial dim, [(lo, hi), ...]: the output
    has ceil(size / stride) elements and the extra pad goes high."""
    pads = []
    for n, k, s, d in zip(size, kernel_size, stride, dilation):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def channel_keep(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]):
    """The (N, C) bool mask of the channels that channel dropout at `rate`
    keeps: uniforms drawn as (N, C, 1, 1) from `generator`, below 1 - rate."""
    u = draw_uniform(generator, (x.shape[0], x.shape[1], 1, 1), torch.float32, x.device)
    return (u < 1.0 - rate).reshape(x.shape[0], x.shape[1])


def channel_dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]):
    """Dropout2d: zero whole channels with probability `rate`, scale the
    kept ones by 1/(1-rate) (flax Dropout with broadcast_dims=(H, W))."""
    keep = channel_keep(x, rate, generator)[:, :, None, None]
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x, rate: float, deterministic: bool, generator):
    """flax Dropout(rate, broadcast_dims=(1, 2)): no draw at rate 0 or when
    deterministic."""
    if deterministic or rate == 0.0:
        return x
    return channel_dropout(x, rate, generator)


class InstanceNorm(nn.Module):
    """Instance norm with single-pass statistics max(E[x^2]-E[x]^2, 0) in
    f32 (f64 when `dtype` is f64), eps 1e-5 and affine parameters; output
    in `dtype`."""

    def __init__(self, channels: int, dtype=torch.float32, epsilon: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.dtype = dtype
        self.epsilon = epsilon

    def forward(self, x):
        xf = x.to(torch.float64 if self.dtype == torch.float64 else torch.float32)
        mean = xf.mean(dim=(2, 3), keepdim=True)
        mean2 = (xf * xf).mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.weight[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(self.dtype)


def group_norm(channels: int) -> InstanceNorm:
    """flax GroupNorm(group_size=1, epsilon=1e-5, dtype=float32)."""
    return InstanceNorm(channels, dtype=torch.float32)


class Conv(nn.Module):
    """Conv2d with f32 parameters computed in `dtype`. `padding` is
    symmetric per dim, or "SAME" (XLA's, flax's default: the odd extra
    pixel goes high). `init_scale` is the variance scale of the
    truncated-normal fan-in init (Kaiming for LeakyReLU by default, 1 for
    flax's default)."""

    def __init__(self, c_in: int, c_out: int, kernel_size=(3, 3), stride=(1, 1),
                 padding=(0, 0), bias: bool = True, dtype=torch.float32,
                 dilation=(1, 1), init_scale: float = _KAIMING_SCALE):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.stride = tuple(stride)
        self.padding = padding if padding == "SAME" else tuple(padding)
        self.dilation = tuple(dilation)
        self.dtype = dtype
        self.init_scale = init_scale

    def reset_parameters(self, generator=None):
        _kaiming_(self.weight, self.weight[0].numel(), generator, self.init_scale)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, add_bias: bool = True):
        b = None if self.bias is None or not add_bias else self.bias.to(self.dtype)
        x = x.to(self.dtype)
        padding = self.padding
        if padding == "SAME":
            pads = same_padding(x.shape[2:], self.weight.shape[2:], self.stride, self.dilation)
            if all(lo == hi for lo, hi in pads):
                padding = tuple(lo for lo, _ in pads)
            else:
                (top, bottom), (left, right) = pads
                x, padding = F.pad(x, (left, right, top, bottom)), (0, 0)
        if wgrad_route(self, x.device, padding) == "kernel":
            return conv1x1_wgrad.Conv1x1.apply(x, self.weight, b, self.stride, self.dilation)
        return F.conv2d(x, self.weight.to(self.dtype), b, self.stride, padding, self.dilation)


def conv(c_in, c_out, kernel_size, stride=1, padding="SAME", dilation=1, bias=False,
         dtype=torch.float32) -> Conv:
    """flax Conv (default init: lecun truncated normal; "SAME" padding)."""
    pair = lambda v: (v, v) if isinstance(v, int) else tuple(v)
    if padding != "SAME":
        padding = pair(padding)
    return Conv(c_in, c_out, pair(kernel_size), pair(stride), padding, bias=bias, dtype=dtype,
                dilation=pair(dilation), init_scale=1.0)


def _transpose_crop(k: int, s: int, padding: str):
    """lax.conv_transpose's (lo, hi) padding of the dilated input for
    `padding` -> where its output starts in torch's unpadded transposed
    conv (which pads k - 1 both sides) and how long it is, less the
    dilated input's length."""
    if padding == "SAME":
        pad_len = k + s - 2
        lo = k - 1 if s > k - 1 else -(-pad_len // 2)
    else:  # VALID
        pad_len = k + s - 2 + max(k - s, 0)
        lo = k - 1
    return (k - 1) - lo, pad_len - k + 1


class ConvTranspose(nn.Module):
    """flax ConvTranspose without bias: a stride-s transposed conv with
    kernel `kernel_size` (default s) and padding "VALID" or "SAME" (lax's,
    cropped out of torch's unpadded output); the weight is in torch's
    (ci, co, kh, kw) orientation, the flax kernel flipped (convert.py)."""

    def __init__(self, c_in: int, c_out: int, stride=(2, 2), dtype=torch.float32,
                 kernel_size=None, padding: str = "VALID",
                 init_scale: float = _KAIMING_SCALE):
        super().__init__()
        kernel_size = tuple(kernel_size or stride)
        self.weight = nn.Parameter(torch.empty(c_in, c_out, *kernel_size))
        self.stride = tuple(stride)
        self.padding = padding
        self.dtype = dtype
        self.init_scale = init_scale

    def reset_parameters(self, generator=None):
        c_in, _, kh, kw = self.weight.shape
        _kaiming_(self.weight, c_in * kh * kw, generator, self.init_scale)

    def forward(self, x):
        y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                               stride=self.stride)
        for dim, (n, k, s) in enumerate(zip(x.shape[2:], self.weight.shape[2:], self.stride)):
            start, extra = _transpose_crop(k, s, self.padding)
            y = y.narrow(2 + dim, start, (n - 1) * s + 1 + extra)
        return y


class Dense(nn.Module):
    """flax Dense computed in `dtype` (f32): x @ kernel + bias, the kernel
    stored as a torch Linear weight (out, in); lecun truncated-normal init,
    zero bias."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.dtype = torch.float32

    def reset_parameters(self, generator=None):
        std = math.sqrt(1.0 / self.weight.shape[1]) / _TRUNC_STD
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """flax max_pool (3, 3), strides 2, padding ((1, 1), (1, 1)): -inf pads."""
    return F.max_pool2d(x, 3, 2, padding=1)


def reset_layers(model: nn.Module, generator: Optional[torch.Generator] = None):
    """Initialise the layers of `model` in module order from `generator`:
    Conv, ConvTranspose and Dense by their own rule, instance norms to unit
    scales and zero biases."""
    for mod in model.modules():
        if isinstance(mod, (Conv, ConvTranspose, Dense)):
            mod.reset_parameters(generator)
        elif isinstance(mod, InstanceNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)


def chain_route(conv: Conv, norm: InstanceNorm, device: torch.device,
                sides: Optional[torch.Tensor] = None) -> str:
    """"kernel" on a CUDA device with the convolution and the norm in f32
    (f32 norm parameters) and no pinned LeakyReLU `sides`: the kernels of
    ops/conv_epilogue.py run the chain after the convolution. Else "plain":
    the CPU, an f64 or bf16 model and a pinned one keep the op-by-op chain."""
    if (device.type == "cuda" and conv.dtype == norm.dtype == torch.float32
            and norm.weight.dtype == torch.float32 and sides is None):
        return "kernel"
    return "plain"


def wgrad_route(conv: Conv, device: torch.device, padding) -> str:
    """"kernel" on a CUDA device for an f32 1x1 convolution (f32 weight)
    with zero padding whose weight needs a gradient under grad mode: its
    weight gradient runs on ops/conv1x1_wgrad.py's kernel, the forward and
    the input's gradient in cuDNN. Else "plain": the CPU, f64 and bf16
    convolutions (a bf16 UNet's head computes in f32 and takes the
    kernel), larger kernels and every forward without a weight gradient
    keep `F.conv2d` and autograd."""
    if (device.type == "cuda" and conv.dtype == conv.weight.dtype == torch.float32
            and tuple(conv.weight.shape[2:]) == (1, 1) and tuple(padding) == (0, 0)
            and conv.weight.requires_grad and torch.is_grad_enabled()):
        return "kernel"
    return "plain"


_ACTIVATIONS = {"leaky_relu": lambda x: F.leaky_relu(x, NEG_SLOPE), "relu": F.relu,
                None: lambda x: x}


def conv_norm(conv: Conv, norm: InstanceNorm, x: torch.Tensor, activation: Optional[str],
              drop: bool = False, rate: float = 0.0, generator=None,
              sides: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv -> [channel dropout at `rate` where `drop`] -> norm ->
    activation ("leaky_relu", "relu" or None; pinned LeakyReLU `sides`,
    bool, give each element its side's slope). On the kernel route the
    convolution runs without its bias and the conv epilogue kernels do the
    rest (a plane they do not take raises)."""
    if chain_route(conv, norm, x.device, sides) == "kernel":
        x = conv(x, add_bias=False)
        keep = channel_keep(x, rate, generator) if drop else None
        return conv_epilogue.conv_epilogue(x, conv.bias, keep, 1.0 - rate, norm.weight,
                                           norm.bias, activation)
    x = conv(x)
    if drop:
        x = channel_dropout(x, rate, generator)
    x = norm(x)
    if sides is not None:
        return torch.where(sides.to(x.device), x, NEG_SLOPE * x)
    return _ACTIVATIONS[activation](x)


def conv_norm_tail(conv: Conv, norm: InstanceNorm, x: torch.Tensor,
                   residual: Callable[[], torch.Tensor], drop: bool = False, rate: float = 0.0,
                   generator=None) -> torch.Tensor:
    """relu([channel dropout at `rate` where `drop`](norm(conv(x))) +
    residual()), a bottleneck's last chain, on the kernel route by the norm
    tail kernels. The keep mask is drawn before `residual` is called."""
    if chain_route(conv, norm, x.device) == "kernel":
        a = conv(x)
        keep = channel_keep(a, rate, generator) if drop else None
        return conv_epilogue.norm_tail(a, keep, 1.0 - rate, norm.weight, norm.bias, residual())
    out = norm(conv(x))
    if drop:
        out = channel_dropout(out, rate, generator)
    return F.relu(out + residual())


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make every layer of `model` (any backbone, a SkewUNet, a
    ConfidenceNet) compute in `dtype`: the convolutions, the head and its
    output, the instance norms (their statistics in f64 for f64, else
    f32), the ConfidenceNet and its Dense layer. The parameters keep their
    dtype: `set_compute_dtype(model.double(), torch.float64)` is an f64
    model throughout. Returns `model`."""
    for mod in model.modules():
        for attr in ("dtype", "head_dtype", "out_dtype"):
            if attr in vars(mod):
                setattr(mod, attr, dtype)
    return model


@contextlib.contextmanager
def conv_output_dtypes(model: nn.Module):
    """Within the block, record the dtype each Conv and ConvTranspose of
    `model` emitted in its last forward (module name -> dtype): a bf16
    model's trunk convolutions give bf16 and its head's f32. Yields the
    record."""
    seen: Dict[str, torch.dtype] = {}

    def record(name):
        return lambda mod, inputs, out: seen.__setitem__(name, out.dtype)

    handles = [mod.register_forward_hook(record(name)) for name, mod in model.named_modules()
               if isinstance(mod, (Conv, ConvTranspose))]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()
