"""Work counts of the benchmark: the UNet's FLOPs from its layer shapes,
the bytes and operations of the kernel K2, the H100's published peaks,
and the card's line.

The FLOPs count what `torch.utils.flop_counter` counts for the UNet: two
per multiply-add of every convolution and transposed convolution (a
forward; the backward's input and weight gradients, with no input
gradient for the stem, whose input needs none). Instance norm, the
activations and the DSNT head are not counted. A CPU test holds these
counts to `flop_counter` on the program's model.

K2's byte formula and HBM_BYTES_PER_S are copied from chip_smoke.py
`kernel_timings` at commit e2ff7a5: K2 reads each heatmap once and writes
8 f32 moments per heatmap.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List, NamedTuple, Sequence

# H100 SXM, NVIDIA's data sheet, dense rates, at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # f32 outside the tensor cores


class ConvShape(NamedTuple):
    stage: str  # "enc<i>" for encoder stage i, "dec<j>" for upsample block j, "head"
    c_in: int
    c_out: int
    kh: int
    kw: int
    h: int  # spatial size the multiply-adds run over (the output's; a
    w: int  # transposed convolution's input's)


def unet_filters(n_stages: int) -> List[int]:
    """Filters of the program's UNet stage i: min(2^(5+i), 480)."""
    return [min(2 ** (5 + i), 480) for i in range(n_stages)]


def unet_convs(in_shape: Sequence[int], n_classes: int, kernels, strides) -> List[ConvShape]:
    """Every convolution of the UNet, in execution order: per encoder stage
    two 3x3 convolutions (the first strided), a bottleneck stage at the last
    stride, per upsample block a transposed convolution and two 3x3
    convolutions over [upsampled, skip], and the 1x1 head."""
    c, h, w = in_shape
    filters = unet_filters(len(strides))
    n_down = len(filters) - 2
    out, sizes, enc = [], [], []
    for idx in range(n_down + 2):
        f = filters[idx] if idx <= n_down else filters[-1]
        (kh, kw), (sh, sw) = kernels[idx], strides[idx]
        h = (h + 2 * (kh // 2) - kh) // sh + 1
        w = (w + 2 * (kw // 2) - kw) // sw + 1
        out.append(ConvShape(f"enc{idx}", c, f, kh, kw, h, w))
        out.append(ConvShape(f"enc{idx}", f, f, kh, kw, h, w))
        sizes.append((h, w))
        enc.append(f)
        c = f
    skips = list(zip(enc[:-1], sizes[:-1]))[::-1]
    up_filters = filters[:-1][::-1]
    up_kernels = list(kernels[1:])[::-1]
    up_strides = list(strides[1:])[::-1]
    for j, (c_skip, (hs, ws)) in enumerate(skips):
        f = up_filters[j]
        sh, sw = up_strides[j]
        out.append(ConvShape(f"dec{j}", c, f, sh, sw, h, w))  # transposed, over its input
        h, w = hs, ws
        kh, kw = up_kernels[j]
        out.append(ConvShape(f"dec{j}", f + c_skip, f, kh, kw, h, w))
        out.append(ConvShape(f"dec{j}", f, f, kh, kw, h, w))
        c = f
    out.append(ConvShape("head", c, n_classes, 1, 1, h, w))
    return out


def conv_flops(conv: ConvShape) -> float:
    return 2.0 * conv.c_in * conv.c_out * conv.kh * conv.kw * conv.h * conv.w


def unet_train_flops(convs: List[ConvShape]) -> float:
    """Forward and backward of one image: the forward, each convolution's
    weight gradient, and each input gradient but the stem's."""
    fwd = sum(conv_flops(c) for c in convs)
    return 3.0 * fwd - conv_flops(convs[0])


def k2_work(rows: int, hw: int, itemsize: int) -> Dict[str, float]:
    """K2 (DSNT moments, row layout) over `rows` heatmaps of `hw` pixels:
    bytes read and written, and operations (max, subtract, exp, 8
    multiplies and 8 adds per pixel)."""
    return {"bytes": rows * hw * itemsize + rows * 8 * 4, "ops": rows * hw * 19}


def bound_seconds(work: Dict[str, float]) -> float:
    """The least time of the work on the card: the larger of its bytes over
    HBM bandwidth and its operations over the f32 peak."""
    return max(work["bytes"] / HBM_BYTES_PER_S, work["ops"] / F32_FLOPS_PER_S)


def card_line() -> str:
    """`name, power.limit` of the card as nvidia-smi reads it ("" without it)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""
