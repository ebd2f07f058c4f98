"""The readers of the 1x1 convolutions' weight gradient kernel
(`conv1x1_routed.train`, `conv1x1_wgrad_ms.train`) on a hand-built traced
epoch of two DeepLabV3-ResNet50 steps, on the CPU: the 40 1x1
convolutions derived from the configuration's `layers`, the reduce pass
kept out of the launch count and in the time, and nothing read without
the program's step spans (or, for the time, without a launch)."""

from types import SimpleNamespace

import pytest

from portbench import devtrace, harness

MANIFEST = harness.Manifest(harness.REPO / "BENCHMARK.json")
KERNEL = "void (anonymous namespace)::conv1x1_wgrad_kernel<256, 64>((anonymous namespace)::Args)"
REDUCE = ("void (anonymous namespace)::conv1x1_wgrad_reduce_kernel(float const*, float*, int, "
          "long long)")
OTHER = "sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc_nchw"
STEPS = [("cut.train.step", 0.0, 1.0), ("cut.train.step", 1.0, 2.0)]


def _epoch(per_step):
    """Two steps, each launching `per_step` (names), 0.5 ms a launch, and
    one cuDNN kernel of 0.1 s."""
    names = per_step * 2
    device = [(n, 0.001 * i, 0.001 * i + 0.0005) for i, n in enumerate(names)]
    device.append((OTHER, 2.0, 2.1))
    return device


def _ctx():
    config = MANIFEST.config("camus-dsnt-al-deeplabv3")
    assert config["model"]["layers"] == [3, 4, 6, 3]
    return SimpleNamespace(config=config)


def test_conv1x1_routed_counts_kernel_launches_per_1x1_convolution():
    reader = MANIFEST.metric_reader("conv1x1_routed.train")
    assert reader.convs([3, 4, 6, 3]) == 40 and reader.convs([1, 1, 1, 1]) == 16
    ctx = _ctx()
    # 40 weight gradients a step, 39 of them split (a reduce pass each).
    routed = devtrace.Reading(window_s=3.0, device=_epoch([KERNEL] * 40 + [REDUCE] * 39),
                              host=STEPS, kind="train")
    half = devtrace.Reading(window_s=3.0, device=_epoch([KERNEL] * 20 + [REDUCE] * 20),
                            host=STEPS, kind="train")
    cudnn = devtrace.Reading(window_s=3.0, device=_epoch([]), host=STEPS, kind="train")
    assert reader.read(routed, ctx) == pytest.approx(100.0)
    assert reader.read(half, ctx) == pytest.approx(50.0)
    assert reader.read(cudnn, ctx) == 0.0
    assert reader.read(devtrace.Reading(window_s=3.0, device=routed.device, kind="train"),
                       ctx) is None


def test_conv1x1_wgrad_ms_sums_both_passes_per_step():
    reader = MANIFEST.metric_reader("conv1x1_wgrad_ms.train")
    ctx = _ctx()
    routed = devtrace.Reading(window_s=3.0, device=_epoch([KERNEL] * 40 + [REDUCE] * 39),
                              host=STEPS, kind="train")
    assert reader.read(routed, ctx) == pytest.approx(79 * 0.5)
    cudnn = devtrace.Reading(window_s=3.0, device=_epoch([]), host=STEPS, kind="train")
    assert reader.read(cudnn, ctx) is None
    assert reader.read(devtrace.Reading(window_s=3.0, device=routed.device, kind="train"),
                       ctx) is None


def test_conv1x1_metrics_read_in_the_deeplabv3_cell_only():
    names = {"conv1x1_routed.train", "conv1x1_wgrad_ms.train"}
    deeplab = {m["name"] for m in MANIFEST.per_layer("camus-dsnt-al-deeplabv3.train")}
    unet = {m["name"] for m in MANIFEST.per_layer("camus-dsnt-al.train")}
    assert names <= deeplab and not names & unet
