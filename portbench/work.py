"""Work counts of the benchmark: a convolution's FLOPs from its shape
(each backbone's count of a training image is its reference module's
`train_flops`, reference/<model_name>.py), the bytes and operations of
the kernel K2, the H100's published peaks, and the card's line.

K2's byte formula and HBM_BYTES_PER_S are copied from chip_smoke.py
`kernel_timings` at commit e2ff7a5: K2 reads each heatmap once and writes
8 f32 moments per heatmap.
"""

from __future__ import annotations

import subprocess
from typing import Dict, NamedTuple

# H100 SXM, NVIDIA's data sheet, dense rates, at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # f32 outside the tensor cores


class ConvShape(NamedTuple):
    stage: str  # the layer's place in its backbone (the UNet's "enc<i>", "dec<j>", "head")
    c_in: int
    c_out: int
    kh: int
    kw: int
    h: int  # spatial size the multiply-adds run over (the output's; a
    w: int  # transposed convolution's input's)


def conv_flops(conv: ConvShape) -> float:
    """Two FLOPs per multiply-add of a (transposed or dilated) convolution."""
    return 2.0 * conv.c_in * conv.c_out * conv.kh * conv.kw * conv.h * conv.w


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
