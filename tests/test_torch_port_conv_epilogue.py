"""The ConvLayer epilogue (ops/conv_epilogue.py, models/unet.py ConvLayer):
the kernels' plain version against autograd of the plain chain (conv bias,
channel dropout, instance norm, LeakyReLU), the kernels' launch plan at
unet2's plane shapes, and which route each model's norm chains take
(models/layers.py `chain_route`, the UNet's and DeepLabV3's).

The CUDA kernels run only on the card (chip_smoke.py [19]); here the
plain version stands in for them where a test forces the kernel route.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from contouring_uncertainty_torch.models import layers
from contouring_uncertainty_torch.models.deeplabv3 import DeepLabV3
from contouring_uncertainty_torch.models.layers import (InstanceNorm, channel_dropout,
                                                        channel_keep, set_compute_dtype)
from contouring_uncertainty_torch.models.unet import ConvLayer, UNet, leaky_relu_sides
from contouring_uncertainty_torch.ops import conv_epilogue as ce

torch.set_num_threads(1)


def _inputs(shape, seed, dtype=torch.float64, near_constant=False):
    """Conv output, conv bias, norm weight and bias, incoming gradient; the
    norm's shift spread so that both sides of every kink are populated."""
    rng = np.random.default_rng(seed)
    n, c = shape[:2]
    if near_constant:  # planes within ~1e-9 of a constant: var rounds below 0 on some
        x = 3.0 + 1e-9 * rng.standard_normal(shape)
    else:
        x = 0.4 + 1.3 * rng.standard_normal(shape)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    return (t(x), t(0.2 * rng.standard_normal(c)), t(1.0 + 0.3 * rng.standard_normal(c)),
            t(0.5 * rng.standard_normal(c)), t(rng.standard_normal(shape)))


def _plain_chain(x, conv_bias, weight, bias, rate, seed):
    """The op-by-op chain of ConvLayer.forward after its convolution, with
    autograd leaves for x, the conv bias and the norm's parameters."""
    norm = InstanceNorm(x.shape[1], dtype=x.dtype)
    norm.weight = torch.nn.Parameter(weight.clone())
    norm.bias = torch.nn.Parameter(bias.clone())
    x, conv_bias = (t.clone().requires_grad_() for t in (x, conv_bias))
    v = x + conv_bias[:, None, None]
    if rate is not None:
        v = channel_dropout(v, rate, torch.Generator().manual_seed(seed))
    return F.leaky_relu(norm(v), 0.01), [x, conv_bias, norm.weight, norm.bias]


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (3, 2, 5, 7), (2, 4, 2, 2)])
@pytest.mark.parametrize("rate", [None, 0.5, 0.3])
def test_closed_form_backward_matches_autograd_of_the_plain_chain(shape, rate):
    """In f64 the plain version's forward is the plain chain's and its
    closed-form backward autograd's (x, conv bias, norm weight and bias),
    with the dropout drawn from the same generator state, whole planes
    dropped and both sides of the kinks populated."""
    x, cb, w, b, gy = _inputs(shape, seed=sum(shape))
    y_ref, leaves = _plain_chain(x, cb, w, b, rate, seed=7)
    grads_ref = torch.autograd.grad(y_ref, leaves, gy)
    keep = None if rate is None else channel_keep(x, rate, torch.Generator().manual_seed(7))
    if keep is not None:
        assert keep.any() or not keep.all()
    keep_prob = 1.0 - (rate or 0.0)
    y, stats = ce.epilogue_plain(x, cb, keep, keep_prob, w, b)
    assert (y > 0).any() and (y < 0).any()
    assert _rel(y, y_ref.detach()) < 1e-13
    got = ce.epilogue_backward_plain(x, cb, keep, keep_prob, w, b, stats, gy)
    for g, r, name in zip(got, grads_ref, ("x", "conv bias", "weight", "bias")):
        assert g.shape == r.shape and g.dtype == torch.float64, name
        # The conv bias's gradient is a sum of dx that cancels to rounding:
        # held to its terms' scale, as all of them are.
        scale = float(grads_ref[0].abs().sum()) if name == "conv bias" else float(r.abs().max())
        assert float((g - r).abs().max()) <= 1e-12 * scale, name


def test_closed_form_backward_on_clamped_planes():
    """Planes whose single-pass variance rounds below 0 are clamped, which
    passes no gradient through the variance: the statistics flag them and
    the closed form drops the term there, as autograd of the clamp does."""
    x, cb, w, b, gy = _inputs((4, 4, 4, 4), seed=0, near_constant=True)
    y_ref, leaves = _plain_chain(x, cb, w, b, None, seed=0)
    grads_ref = torch.autograd.grad(y_ref, leaves, gy)
    y, stats = ce.epilogue_plain(x, cb, None, 1.0, w, b)
    assert (stats[2] == 0).any() and (stats[2] == 1).any()
    assert _rel(y, y_ref.detach()) < 1e-13
    got = ce.epilogue_backward_plain(x, cb, None, 1.0, w, b, stats, gy)
    for g, r in zip((got[0], got[2], got[3]), (grads_ref[0], grads_ref[2], grads_ref[3])):
        assert _rel(g, r) < 1e-9


@pytest.mark.parametrize("rate", [None, 0.5])
def test_plain_version_forward_matches_the_plain_chain_in_f32(rate):
    x, cb, w, b, _ = _inputs((2, 5, 16, 16), seed=3, dtype=torch.float32)
    y_ref, _ = _plain_chain(x, cb, w, b, rate, seed=11)
    keep = None if rate is None else channel_keep(x, rate, torch.Generator().manual_seed(11))
    y, stats = ce.epilogue_plain(x, cb, keep, 1.0 - (rate or 0.0), w, b)
    assert y.dtype == stats.dtype == torch.float32 and stats.shape == (3, 10)
    np.testing.assert_allclose(y.numpy(), y_ref.detach().numpy(), rtol=0, atol=1e-6)


# unet2's 15 ConvBlocks (8 encoder, 7 decoder; two ConvLayers each) at 256^2:
# (channels, plane side) and the launch each plane size takes.
UNET2_BLOCKS = [(32, 256), (64, 128), (128, 64), (256, 32), (480, 16), (480, 8), (480, 4),
                (480, 2), (480, 4), (480, 8), (480, 16), (256, 32), (128, 64), (64, 128),
                (32, 256)]
# side -> (vecs, group, cluster): clusters above 8192 floats a plane, planes
# packed below.
UNET2_PLANS = {256: (4, 512, 8), 128: (4, 512, 2), 64: (4, 256, 1), 32: (4, 64, 1),
               16: (4, 16, 1), 8: (4, 4, 1), 4: (4, 1, 1), 2: (1, 1, 1)}


@pytest.mark.parametrize("batch", [32, 1])
@pytest.mark.parametrize("block", range(len(UNET2_BLOCKS)))
def test_conv_epilogue_launch_plan(block, batch):
    """The kernels' launch at each of unet2's planes: 16-byte vectors,
    at most 16 floats a thread, a cluster of at most 8 blocks (only where
    a plane outgrows a block, and then the group is the whole block),
    else the fewest threads (a power of two) that hold the plane, several
    planes to a block."""
    channels, side = UNET2_BLOCKS[block]
    x = torch.empty(batch, channels, side, side, device="meta")
    plan = ce.epilogue_plan(x)
    hw = side * side
    assert (plan.vecs, plan.group, plan.cluster) == UNET2_PLANS[side]
    assert plan.vec == 4 and plan.vec * plan.vecs <= ce.MAX_ELEMS
    assert plan.group * plan.vecs * plan.vec * plan.cluster >= hw
    assert plan.cluster <= ce.MAX_CLUSTER
    if plan.cluster > 1:
        assert plan.group == ce.THREADS and hw > ce.THREADS * ce.MAX_ELEMS
        assert (plan.cluster - 1) * ce.THREADS * ce.MAX_ELEMS < hw
    else:
        assert plan.group == 1 or (plan.group // 2) * ce.MAX_ELEMS < hw
    assert plan.planes_per_block == ce.THREADS // plan.group
    if side <= 64:
        assert plan.planes_per_block >= 2


def test_conv_epilogue_launch_plan_takes_odd_planes_with_scalar_loads():
    """A plane whose size is not a multiple of 4, or planes not 16-byte
    aligned, take 4-byte loads (up to 16 a thread)."""
    plan = ce.epilogue_plan(torch.empty(2, 3, 5, 7, device="meta"))
    assert (plan.vec, plan.vecs, plan.group, plan.cluster) == (1, 16, 4, 1)
    buf = torch.empty(1 + 2 * 3 * 16 * 16)
    shifted = buf[1:].view(2, 3, 16, 16)
    assert shifted.data_ptr() % 16 and ce.epilogue_plan(shifted).vec == 1
    plan = ce.epilogue_plan(torch.empty(1, 1, 255, 255, device="meta"))
    assert (plan.vec, plan.group, plan.cluster) == (1, ce.THREADS, 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64])
def test_conv_epilogue_launch_plan_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="take f32"):
        ce.epilogue_plan(torch.empty(2, 3, 8, 8, dtype=dtype, device="meta"))


@pytest.mark.parametrize("make", [
    lambda: torch.empty(2, 3, 8, 8, device="meta").to(memory_format=torch.channels_last),
    lambda: torch.empty(2, 3, 8, 8, device="meta").transpose(2, 3),
    lambda: torch.empty(3, 8, 8, device="meta"),
    lambda: torch.empty(1, 2, 512, 512, device="meta"),
])
def test_conv_epilogue_launch_plan_refuses_other_layouts(make):
    """Channels-last or transposed planes, another rank and a plane over
    MAX_PLANE (512^2) raise."""
    with pytest.raises(ValueError, match="conv epilogue kernels take"):
        ce.epilogue_plan(make())


def test_conv_epilogue_kernels_refuse_cpu_tensors():
    """The kernels' wrappers and the Function take CUDA tensors only: a
    CPU tensor raises before any launch (the CPU takes the op-by-op chain,
    by models/layers.py `chain_route`)."""
    x, cb, w, b, gy = _inputs((2, 3, 8, 8), seed=5, dtype=torch.float32)
    for call in (lambda: ce.epilogue_cuda(x, cb, None, 1.0, w, b),
                 lambda: ce.conv_epilogue(x, cb, None, 1.0, w, b),
                 lambda: ce.epilogue_backward_cuda(x, cb, None, 1.0, w, b,
                                                   torch.zeros(3, 6), gy)):
        with pytest.raises(ValueError, match="take CUDA tensors"):
            call()
    assert ce.fwd_launches == ce.bwd_launches == 0


def _small_unet(dtype=torch.float32, drop_block=True, seed=0):
    model = UNet((1, 32, 32), (3, 32, 32), kernels=((3, 3),) * 4,
                 strides=((1, 1),) + ((2, 2),) * 3, drop_block=drop_block, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def _small_deeplab(dtype=torch.float32, seed=0):
    model = DeepLabV3((1, 32, 32), (3, 32, 32), layers=(1, 1, 1, 1), base=8, dropout=0.3,
                      dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


SMALL_MODELS = {"unet": _small_unet, "deeplabv3": _small_deeplab}


def _norm_chains(model):
    """`chain_route`'s (conv, norm, pinned sides) of every norm chain: a
    UNet's ConvLayers; a DeepLabV3's GroupNorm_i after Conv_i, or after
    head_conv_i in the head."""
    if isinstance(model, UNet):
        return [(m.Conv_0, m.InstanceNorm_0, m.pinned_sides) for m in model.modules()
                if isinstance(m, ConvLayer)]
    out = []
    for mod in model.modules():
        for child, norm in mod.named_children():
            if child.startswith("GroupNorm_"):
                i = child.split("_")[1]
                conv = getattr(mod, f"Conv_{i}", None) or getattr(mod, f"head_conv_{i}")
                out.append((conv, norm, None))
    return out


@pytest.mark.parametrize("name", list(SMALL_MODELS))
def test_chain_route_follows_the_device_dtype_and_pinning(name):
    """An f32 model's norm chains take the kernels on a CUDA device and
    the op-by-op chain on the CPU; an f64 model, a bf16 one and a UNet
    pinned by `leaky_relu_sides(pin=...)` take the op-by-op chain on a
    CUDA device too (the route is read from the device and the layers,
    nothing runs). The small UNet has 14 ConvLayers, the small DeepLabV3
    24 norms, as the benchmark's `norm_fused.train` counts them."""
    from portbench import harness

    build = SMALL_MODELS[name]
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def routes(model, device):
        return {layers.chain_route(c, n, device, s) for c, n, s in _norm_chains(model)}

    f32 = build()
    if name == "unet":
        assert len(_norm_chains(f32)) == 2 * (2 * 4 - 1)
    else:
        reader = harness.Manifest(harness.REPO / "BENCHMARK.json").metric_reader(
            "norm_fused.train")
        assert len(_norm_chains(f32)) == reader.norms((1, 1, 1, 1)) == 24
    assert routes(f32, cuda) == {"kernel"}
    assert routes(f32, cpu) == {"plain"}
    f64 = set_compute_dtype(build().double(), torch.float64)
    bf16 = build(dtype=torch.bfloat16)
    for model in (f64, bf16):
        assert routes(model, cuda) == {"plain"}
    if name == "unet":
        x = torch.randn(2, 1, 32, 32)
        with leaky_relu_sides(f32) as sides:
            f32(x)
        with leaky_relu_sides(f32, sides):
            assert routes(f32, cuda) == {"plain"}
        assert routes(f32, cuda) == {"kernel"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_leaky_relu_sides_records_the_pre_activation_sign(dtype):
    """The recorded side of every activation is the sign of its
    pre-activation (the norm's output), read from the ConvLayer's output."""
    model = _small_unet(dtype=dtype)
    pre, handles = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, ConvLayer):
            handles.append(mod.InstanceNorm_0.register_forward_hook(
                lambda m, i, y, name=name: pre.__setitem__(name, y.detach())))
    x = torch.randn(2, 1, 32, 32, generator=torch.Generator().manual_seed(1))
    with leaky_relu_sides(model) as sides:
        model(x, deterministic=False, generator=torch.Generator().manual_seed(2))
    for h in handles:
        h.remove()
    assert set(sides) == set(pre) and len(sides) == 14
    for name, s in sides.items():
        assert s.dtype == torch.bool and torch.equal(s, pre[name] > 0), name
        assert s.any() and not s.all(), name


def _plain_kernels(monkeypatch):
    """Force the kernel route on the CPU, with the plain versions in the
    kernels' place inside the Functions."""
    def forward(x, *args):
        ce.epilogue_plan(x)  # what the kernels refuse, refused
        return ce.epilogue_plain(x, *args)

    def tail(a, keep, keep_prob, weight, bias, r):
        ce.epilogue_plan(a, r)
        return ce.tail_plain(a, keep, keep_prob, weight, bias, r)

    monkeypatch.setattr(layers, "chain_route", lambda *args: "kernel")
    monkeypatch.setattr(ce, "epilogue_cuda", forward)
    monkeypatch.setattr(ce, "epilogue_backward_cuda", ce.epilogue_backward_plain)
    monkeypatch.setattr(ce, "tail_cuda", tail)
    monkeypatch.setattr(ce, "tail_backward_cuda", ce.tail_backward_plain)


def test_kernel_route_on_the_cpu_matches_the_plain_chain(monkeypatch):
    """With the kernel route forced on the CPU (the Function then runs the
    plain version in the kernels' place), a UNet's training forward and
    backward match the
    op-by-op chain's: the same dropout draws in the same order (the
    generators end equal), outputs and every gradient within f32 rounding
    (the conv biases' exact-zero gradients within rounding of the largest
    gradient), the conv biases' gradients computed."""
    x = torch.randn(3, 1, 32, 32, generator=torch.Generator().manual_seed(4))

    def run():
        model = _small_unet(seed=3)
        gen = torch.Generator().manual_seed(9)
        out = model(x, deterministic=False, generator=gen)["out"]
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        return out.detach(), {n: p.grad for n, p in model.named_parameters()}, gen.get_state()

    plain = run()
    _plain_kernels(monkeypatch)
    calls = []
    real = ce.conv_epilogue
    monkeypatch.setattr(ce, "conv_epilogue", lambda *a: calls.append(a[2] is not None) or real(*a))
    fused = run()
    assert len(calls) == 14 and sum(calls) == 6  # dropout in the two deepest stages
    assert torch.equal(plain[2], fused[2])
    np.testing.assert_allclose(fused[0].numpy(), plain[0].numpy(), rtol=0,
                               atol=2e-5 * float(plain[0].abs().max()))
    top = max(float(g.abs().max()) for g in plain[1].values())
    for name, g in plain[1].items():
        got = fused[1][name]
        assert got is not None, name
        tol = (1e-5 * top if name.endswith("Conv_0.bias") and ".ConvLayer_" in name
               else 2e-4 * float(g.abs().max()) + 1e-6 * top)
        assert float((got - g).abs().max()) <= tol, name


@pytest.mark.parametrize("name,chains", [("unet", 14), ("deeplabv3", 24)])
def test_every_fused_chain_takes_the_route(name, chains, monkeypatch):
    """In one training forward and backward of the small UNet (14
    ConvLayers) and the small DeepLabV3 (24 norms), with the plain
    versions in the kernels' place, `chain_route` answers "kernel" once a
    chain when asked for a CUDA device, and the kernels launch once a
    chain each way: no fused chain reaches the kernels without the
    route."""
    real_route = layers.chain_route
    _plain_kernels(monkeypatch)
    answers, launches = [], []

    def on_card(conv, norm, device, sides=None):
        answers.append(real_route(conv, norm, torch.device("cuda"), sides))
        return answers[-1]

    monkeypatch.setattr(layers, "chain_route", on_card)
    for fn in ("epilogue_cuda", "epilogue_backward_cuda", "tail_cuda", "tail_backward_cuda"):
        inner = getattr(ce, fn)
        monkeypatch.setattr(ce, fn, lambda *a, inner=inner, fn=fn, **k:
                            launches.append(fn) or inner(*a, **k))
    model = SMALL_MODELS[name](seed=2)
    out = model(torch.randn(2, 1, 32, 32), deterministic=False,
                generator=torch.Generator().manual_seed(3))["out"]
    out.square().sum().backward()
    assert answers == ["kernel"] * chains
    forward = launches.count("epilogue_cuda") + launches.count("tail_cuda")
    backward = launches.count("epilogue_backward_cuda") + launches.count("tail_backward_cuda")
    assert forward == backward == chains
    assert launches.count("tail_cuda") == (4 if name == "deeplabv3" else 0)


def test_conv_layer_refuses_planes_over_the_kernels_limit(monkeypatch):
    """On the kernel route a ConvLayer whose plane has more than MAX_PLANE
    elements raises the launch plan's error: no layer quietly takes the
    op-by-op chain on the card."""
    _plain_kernels(monkeypatch)
    layer = ConvLayer(1, 2)
    with pytest.raises(ValueError, match="planes of at most 65536"):
        layer(torch.zeros(1, 1, 257, 256))
    assert layer(torch.zeros(1, 1, 256, 256)).shape == (1, 2, 256, 256)


def test_epilogue_fused_metric_counts_launches_per_conv_layer():
    """portbench's `epilogue_fused.train` on a hand-built traced epoch of
    two steps of unet2 (30 ConvLayers): 100 with one forward and one
    backward kernel a layer a step, 0 with none (the op-by-op chain),
    nothing without the program's step spans."""
    from types import SimpleNamespace

    from portbench import devtrace, harness

    manifest = harness.Manifest(harness.REPO / "BENCHMARK.json")
    reader = manifest.metric_reader("epilogue_fused.train")
    ctx = SimpleNamespace(config=manifest.config("camus-dsnt-al"))
    names = ["void (anonymous namespace)::conv_epilogue_fwd_kernel<4, 4>(Args)",
             "void (anonymous namespace)::conv_epilogue_bwd_kernel<4, 4>(Args)"]
    device = [(names[i % 2], 0.01 * i, 0.01 * i + 0.005) for i in range(2 * 2 * 30)]
    device.append(("void at::native::vectorized_elementwise_kernel<4>", 2.0, 2.1))
    host = [("cut.train.step", 0.0, 1.0), ("cut.train.step", 1.0, 2.0)]
    fused = devtrace.Reading(window_s=3.0, device=device, host=host, kind="train")
    plain = devtrace.Reading(window_s=3.0, device=device[-1:], host=host, kind="train")
    assert reader.read(fused, ctx) == pytest.approx(100.0)
    assert reader.read(plain, ctx) == 0.0
    assert reader.read(devtrace.Reading(window_s=3.0, device=device, kind="train"), ctx) is None


def test_norm_fused_metric_counts_launches_per_deeplabv3_norm():
    """portbench's `norm_fused.train` on a hand-built traced epoch of two
    steps of DeepLabV3-ResNet50 (layers [3, 4, 6, 3]: 60 norms): 100 with
    one forward and one backward kernel a norm a step (the conv epilogue's
    and the norm tail's), 0 with none (the op-by-op chains), nothing
    without the program's step spans."""
    from types import SimpleNamespace

    from portbench import devtrace, harness

    manifest = harness.Manifest(harness.REPO / "BENCHMARK.json")
    reader = manifest.metric_reader("norm_fused.train")
    config = manifest.config("camus-dsnt-al-deeplabv3")
    assert config["model"]["layers"] == [3, 4, 6, 3] and reader.norms([3, 4, 6, 3]) == 60
    ctx = SimpleNamespace(config=config)
    names = ["void (anonymous namespace)::conv_epilogue_fwd_kernel<1, 4, 4>(Args)",
             "void (anonymous namespace)::conv_epilogue_bwd_kernel<1, 4, 4>(Args)",
             "void (anonymous namespace)::norm_tail_fwd_kernel<4, 4>(Args)",
             "void (anonymous namespace)::norm_tail_bwd_kernel<4, 4>(Args)"]
    # Per step: 44 epilogue chains and 16 tails, each a forward and a backward.
    per_step = [names[0], names[1]] * 44 + [names[2], names[3]] * 16
    device = [(n, 0.001 * i, 0.001 * i + 0.0005) for i, n in enumerate(per_step * 2)]
    device.append(("void at::native::vectorized_elementwise_kernel<4>", 2.0, 2.1))
    host = [("cut.train.step", 0.0, 1.0), ("cut.train.step", 1.0, 2.0)]
    fused = devtrace.Reading(window_s=3.0, device=device, host=host, kind="train")
    plain = devtrace.Reading(window_s=3.0, device=device[-1:], host=host, kind="train")
    assert reader.read(fused, ctx) == pytest.approx(100.0)
    assert reader.read(plain, ctx) == 0.0
    assert reader.read(devtrace.Reading(window_s=3.0, device=device, kind="train"), ctx) is None
