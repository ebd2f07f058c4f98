"""DeepLabV3's norm chains on the kernel route (models/layers.py
`conv_norm` and `conv_norm_tail`, ops/conv_epilogue.py): the plain versions
of the three chains against autograd of the op-by-op chain (A: conv ->
GroupNorm -> ReLU; P: conv -> GroupNorm; T: a bottleneck's last norm,
channel dropout after it, the residual add and the ReLU), a small DeepLabV3
with the kernel route forced on the CPU against the op-by-op model, and the
launch plan at DeepLabV3's plane shapes (which route each model takes:
tests/test_torch_port_conv_epilogue.py).

The CUDA kernels run only on the card (chip_smoke.py [20]); here the plain
versions stand in for them where a test forces the kernel route.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from contouring_uncertainty_torch.models import layers
from contouring_uncertainty_torch.models.deeplabv3 import DeepLabV3
from contouring_uncertainty_torch.models.layers import InstanceNorm, channel_dropout, channel_keep
from contouring_uncertainty_torch.ops import conv_epilogue as ce

torch.set_num_threads(1)

# ASPP's pooled branch (1x1 planes), a plane of 16^2, an odd plane, and
# planes within ~1e-9 of a constant (the single-pass variance clamped on some).
SHAPES = {"pooled 1x1": (3, 4, 1, 1), "16x16": (2, 3, 16, 16), "5x7": (3, 2, 5, 7),
          "clamped": (4, 4, 4, 4)}


def _inputs(name, seed, dtype=torch.float64):
    """Conv output, norm weight and bias, residual and incoming gradient."""
    shape = SHAPES[name]
    rng = np.random.default_rng(seed)
    c = shape[1]
    if name == "clamped":
        a = 3.0 + 1e-9 * rng.standard_normal(shape)
    else:
        a = 0.4 + 1.3 * rng.standard_normal(shape)
    t = lambda v: torch.as_tensor(v, dtype=dtype)
    return (t(a), t(1.0 + 0.3 * rng.standard_normal(c)), t(0.5 * rng.standard_normal(c)),
            t(0.7 * rng.standard_normal(shape)), t(rng.standard_normal(shape)))


def _norm(weight, bias, dtype):
    norm = InstanceNorm(weight.shape[0], dtype=dtype)
    norm.weight = torch.nn.Parameter(weight.clone())
    norm.bias = torch.nn.Parameter(bias.clone())
    return norm


def _scale(r):
    return max(float(r.detach().abs().max()), 1e-300)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("relu", [True, False], ids=["A relu", "P none"])
def test_conv_norm_plain_version_matches_autograd(shape, relu):
    """Chains A and P: in f64 the plain version's forward is the op-by-op
    chain's and its closed-form backward autograd's (conv output, norm
    weight and bias); no conv bias, no dropout. On ASPP's 1x1 planes the
    norm gives exactly its bias."""
    a, w, b, _, gy = _inputs(shape, seed=len(shape) + relu)
    norm = _norm(w, b, torch.float64)
    al = a.clone().requires_grad_()
    y_ref = norm(al)
    y_ref = F.relu(y_ref) if relu else y_ref
    grads_ref = torch.autograd.grad(y_ref, [al, norm.weight, norm.bias], gy)
    activation = "relu" if relu else None
    y, stats = ce.epilogue_plain(a, None, None, 1.0, w, b, activation)
    assert torch.allclose(y, y_ref.detach(), rtol=0, atol=1e-13 * _scale(y_ref))
    if shape == "pooled 1x1":
        z = b[None, :, None, None].expand_as(a)
        assert torch.equal(y, F.relu(z) if relu else z)
    if shape == "clamped":
        assert (stats[2] == 0).any() and (stats[2] == 1).any()
    dx, dcb, dw, db = ce.epilogue_backward_plain(a, None, None, 1.0, w, b, stats, gy,
                                                 activation=activation)
    tol = 1e-9 if shape == "clamped" else 1e-12
    for g, r, name in zip((dx, dw, db), grads_ref, ("x", "weight", "bias")):
        assert g.shape == r.shape and g.dtype == torch.float64, name
        assert float((g - r).abs().max()) <= tol * _scale(r), name


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("rate", [None, 0.3])
def test_norm_tail_plain_version_matches_autograd(shape, rate):
    """Chain T: in f64 relu(dropout(norm(a)) + r), the dropout after the
    norm drawn from the same generator state, against autograd of the
    op-by-op chain: y, and the gradients of a, the norm's weight and bias
    and the residual; a dropped plane's da is 0."""
    a, w, b, r, gy = _inputs(shape, seed=3 * len(shape) + (rate is None))
    norm = _norm(w, b, torch.float64)
    al, rl = a.clone().requires_grad_(), r.clone().requires_grad_()
    z = norm(al)
    if rate is not None:
        z = channel_dropout(z, rate, torch.Generator().manual_seed(5))
    y_ref = F.relu(z + rl)
    grads_ref = torch.autograd.grad(y_ref, [al, norm.weight, norm.bias, rl], gy)
    keep = None if rate is None else channel_keep(a, rate, torch.Generator().manual_seed(5))
    keep_prob = 1.0 - (rate or 0.0)
    y, stats = ce.tail_plain(a, keep, keep_prob, w, b, r)
    assert (y > 0).any() and (y == 0).any()
    assert torch.allclose(y, y_ref.detach(), rtol=0, atol=1e-13 * _scale(y_ref))
    got = ce.tail_backward_plain(a, keep, keep_prob, w, b, stats, y, gy)
    tol = 1e-9 if shape == "clamped" else 1e-12
    for g, ref, name in zip(got, grads_ref, ("a", "weight", "bias", "residual")):
        assert g.shape == ref.shape and g.dtype == torch.float64, name
        assert float((g - ref).abs().max()) <= tol * _scale(ref), name
    if keep is not None:
        assert not keep.all()
        assert torch.equal(got[0][~keep], torch.zeros_like(got[0][~keep]))


def _small_deeplab(dtype=torch.float32, seed=0):
    model = DeepLabV3((1, 32, 32), (3, 32, 32), layers=(1, 1, 1, 1), base=8, dropout=0.3,
                      dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def _plain_kernels(monkeypatch):
    """Force the kernel route on the CPU, with the plain versions in the
    kernels' place inside the Functions (what the kernels refuse, refused)."""
    def forward(x, *args):
        ce.epilogue_plan(x)
        return ce.epilogue_plain(x, *args)

    def tail(a, keep, keep_prob, weight, bias, r):
        ce.epilogue_plan(a, r)
        return ce.tail_plain(a, keep, keep_prob, weight, bias, r)

    monkeypatch.setattr(layers, "chain_route", lambda *args: "kernel")
    monkeypatch.setattr(ce, "epilogue_cuda", forward)
    monkeypatch.setattr(ce, "epilogue_backward_cuda", ce.epilogue_backward_plain)
    monkeypatch.setattr(ce, "tail_cuda", tail)
    monkeypatch.setattr(ce, "tail_backward_cuda", ce.tail_backward_plain)


def test_kernel_route_on_the_cpu_matches_the_op_by_op_model(monkeypatch):
    """With the kernel route forced on the CPU (the Functions then run the
    plain versions in the kernels' place), a base-8 DeepLabV3 of one
    bottleneck a stage matches the op-by-op model in a training forward
    and backward: the same keep masks drawn in the same order (the
    generators end equal), outputs, loss and every gradient within f32
    rounding; 20 chains through the epilogue and 4 through the tail."""
    x = torch.randn(3, 1, 32, 32, generator=torch.Generator().manual_seed(4))
    real_keep = layers.channel_keep

    def run():
        masks = []

        def record(t, rate, gen):
            masks.append(real_keep(t, rate, gen))
            return masks[-1]

        monkeypatch.setattr(layers, "channel_keep", record)
        model = _small_deeplab(seed=3)
        gen = torch.Generator().manual_seed(9)
        out = model(x, deterministic=False, generator=gen)["out"]
        state = gen.get_state()
        loss = (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum()
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        return out.detach(), float(loss.detach()), grads, state, masks

    plain = run()
    _plain_kernels(monkeypatch)
    calls = {"epilogue": [], "tail": []}
    real_epilogue, real_tail = ce.conv_epilogue, ce.norm_tail
    monkeypatch.setattr(ce, "conv_epilogue",
                        lambda *a: calls["epilogue"].append(a[6]) or real_epilogue(*a))
    monkeypatch.setattr(ce, "norm_tail",
                        lambda *a: calls["tail"].append(a[1] is not None) or real_tail(*a))
    fused = run()
    assert calls["epilogue"].count("relu") == 16 and calls["epilogue"].count(None) == 4
    assert calls["tail"] == [True] * 4
    assert torch.equal(plain[3], fused[3])
    assert len(plain[4]) == len(fused[4]) == 4
    for m_plain, m_fused in zip(plain[4], fused[4]):
        assert torch.equal(m_plain, m_fused)
    assert any(not m.all() for m in fused[4])
    np.testing.assert_allclose(fused[0].numpy(), plain[0].numpy(), rtol=0,
                               atol=2e-5 * float(plain[0].abs().max()))
    assert abs(fused[1] - plain[1]) <= 2e-5 * abs(plain[1])
    top = max(float(g.abs().max()) for g in plain[2].values())
    for name, g in plain[2].items():
        got = fused[2][name]
        assert got is not None, name
        assert float((got - g).abs().max()) <= 2e-4 * float(g.abs().max()) + 1e-6 * top, name


def test_kernel_route_refuses_what_the_kernels_do_not_take(monkeypatch):
    """On the kernel route nothing falls back to the op-by-op chain: a
    plane over MAX_PLANE raises the launch plan's error, a residual of
    another shape or dtype raises, and CPU tensors raise in the kernels'
    own wrappers."""
    _plain_kernels(monkeypatch)
    model = _small_deeplab()
    stem = model.ResNetBackbone_0
    with pytest.raises(ValueError, match="planes of at most 65536"):
        layers.conv_norm(stem.Conv_0, stem.GroupNorm_0, torch.zeros(1, 1, 514, 512), "relu")
    a, w, b, r, gy = _inputs("16x16", seed=1, dtype=torch.float32)
    monkeypatch.undo()
    for bad in (r[:, :, :8], r.double()):
        with pytest.raises(ValueError, match="the residual must be"):
            ce.tail_cuda(a, None, 1.0, w, b, bad)
    for call in (lambda: ce.tail_cuda(a, None, 1.0, w, b, r),
                 lambda: ce.norm_tail(a, None, 1.0, w, b, r),
                 lambda: ce.tail_backward_cuda(a, None, 1.0, w, b, torch.zeros(3, 6), r, gy),
                 lambda: ce.conv_epilogue(a, None, None, 1.0, w, b, "relu")):
        with pytest.raises(ValueError, match="take CUDA tensors"):
            call()
    with pytest.raises(ValueError, match="activation is one of"):
        ce.epilogue_plain(a, None, None, 1.0, w, b, "gelu")
    assert ce.tail_fwd_launches == ce.tail_bwd_launches == 0


# DeepLabV3's planes at 256^2 (channels, side): the stem, the four stages
# (stage 4 dilated at 16^2), ASPP and its pooled branch, and the head; the
# launch each plane size takes: side -> (vec, vecs, group, cluster).
DEEPLAB_PLANES = [(64, 128), (64, 64), (256, 64), (128, 32), (512, 32), (256, 16), (1024, 16),
                  (512, 16), (2048, 16), (256, 1)]
DEEPLAB_PLANS = {128: (4, 4, 512, 2), 64: (4, 4, 256, 1), 32: (4, 4, 64, 1), 16: (4, 4, 16, 1),
                 1: (1, 1, 1, 1)}


@pytest.mark.parametrize("batch", [32, 1])
@pytest.mark.parametrize("plane", DEEPLAB_PLANES, ids=lambda p: f"{p[0]}x{p[1]}^2")
def test_norm_chain_launch_plan_at_deeplabv3_planes(plane, batch):
    """Both kernel pairs' launch at DeepLabV3's planes, 128^2 down to ASPP's
    pooled 1^2: 16-byte vectors where the plane is a multiple of 4, a
    cluster of 2 for 128^2, several planes a block at 64^2 and below, one
    thread a plane of one element; the tail's residual and the backward's
    y and gy laid out beside the conv output."""
    channels, side = plane
    x = torch.empty(batch, channels, side, side, device="meta")
    plan = ce.epilogue_plan(x, x, x)
    assert (plan.vec, plan.vecs, plan.group, plan.cluster) == DEEPLAB_PLANS[side]
    assert plan.group * plan.vecs * plan.vec * plan.cluster >= side * side
    assert plan.planes_per_block == ce.THREADS // plan.group
    if side <= 64:
        assert plan.planes_per_block >= 2
