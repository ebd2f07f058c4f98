"""The UNet's FLOP count (reference/unet2.py, found by the configuration's
`model_name`) against torch.utils.flop_counter on the program's UNet, and
K2's byte count against the formula it was copied from."""

from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, work

REPO = Path(__file__).resolve().parents[2]
MANIFEST = harness.Manifest(REPO / "BENCHMARK.json")
CONFIG = MANIFEST.config("camus-dsnt-al")
UNET = MANIFEST.backbone(CONFIG["model_name"])
SIZES = [(64, ((3, 3),) * 4, ((1, 1),) + ((2, 2),) * 3),
         (256, ((3, 3),) * 8, ((1, 1),) + ((2, 2),) * 7)]


@pytest.mark.parametrize("size,kernels,strides", SIZES, ids=["64px-4stage", "256px-8stage"])
def test_unet_flops_match_flop_counter(size, kernels, strides):
    from contouring_uncertainty_torch.models.unet import UNet

    with torch.device("meta"):
        model = UNet((1, size, size), (21, size, size), kernels=kernels, strides=strides,
                     drop_block=True)
    x = torch.empty(2, 1, size, size, device="meta")
    convs = UNET.unet_convs((1, size, size), 21, kernels, strides)
    with FlopCounterMode(display=False) as fc:
        model(x)
    assert fc.get_total_flops() == 2 * sum(map(work.conv_flops, convs))
    with FlopCounterMode(display=False) as fc:
        model(x)["out"].sum().backward()
    assert fc.get_total_flops() == 2 * UNET.train_flops(
        (1, size, size), 21, {"kernels": kernels, "strides": strides})


def test_published_counts():
    """camus-dsnt-al's UNet at 256x256, K = 21, through the lookup by
    `model_name`: 28.98 GFLOP forward, 86.91 a training image."""
    assert CONFIG["model_name"] == "unet2"
    m = CONFIG["model"]
    convs = UNET.unet_convs((1, 256, 256), 21, m["kernels"], m["strides"])
    assert round(sum(map(work.conv_flops, convs)) / 1e9, 2) == 28.98
    assert round(UNET.train_flops((1, 256, 256), 21, m) / 1e9, 2) == 86.91


@pytest.mark.parametrize("rows,hw,itemsize", [(672, 65536, 4), (420, 65536, 2), (42, 4096, 4)])
def test_k2_bytes_are_the_copied_formula(rows, hw, itemsize):
    # chip_smoke.py kernel_timings: rows*HW*itemsize + rows*8*4; 19 operations a pixel.
    w = work.k2_work(rows, hw, itemsize)
    assert w == {"bytes": hw * rows * itemsize + rows * 32, "ops": rows * hw * 19}
    assert work.bound_seconds(w) == pytest.approx(
        max((hw * rows * itemsize + rows * 32) / 3.35e12, rows * hw * 19 / 67e12))
