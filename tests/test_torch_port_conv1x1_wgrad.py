"""The 1x1 convolutions' weight gradient (ops/conv1x1_wgrad.py) and its
route (models/layers.py `wgrad_route`): the plain version against
`torch.nn.grad.conv2d_weight` and the autograd Function against autograd
of `F.conv2d` in f64 at DeepLabV3's 1x1 shape classes (cut widths), the
route's predicate, the split plan at every 1x1 of both benchmark cells
(batch 32, 256^2), the wrappers' refusals, every backbone's CPU training
step bitwise the plain route's, and the route forced on the CPU (the
Function with the plain version in the kernel's place) against the plain
route.

The CUDA kernel runs only on the card (chip_smoke.py [21]).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from contouring_uncertainty_torch.models import build_backbone, layers
from contouring_uncertainty_torch.ops import conv1x1_wgrad as cw

torch.set_num_threads(1)

# (Co, Ci, H, W, stride, bias): DeepLabV3's 1x1 classes at cut widths
# (a bottleneck's expansion and reduction, a stride-2 projection on an
# even and an odd map, ASPP's pooled branch at P = 1, the 21-landmark
# head with its bias) and the UNet's head.
CLASSES = {
    "expand": (16, 4, 8, 8, 1, False), "reduce": (4, 16, 8, 8, 1, False),
    "project s2": (32, 16, 8, 8, 2, False), "project s2 odd": (32, 16, 7, 7, 2, False),
    "pooled P=1": (16, 64, 1, 1, 1, False), "head 21 bias": (21, 16, 4, 4, 1, True),
    "unet head": (21, 8, 16, 16, 1, True),
}


def _case(name, dtype=torch.float64, n=3, seed=0):
    co, ci, h, w, s, bias = CLASSES[name]
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    x, weight = t(n, ci, h, w), t(co, ci, 1, 1)
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    return x, weight, t(co) if bias else None, t(n, co, ho, wo), (s, s)


@pytest.mark.parametrize("name", list(CLASSES))
def test_plain_wgrad_and_function_match_autograd_in_f64(name):
    """wgrad_plain is conv2d_weight's gradient; Conv1x1's forward is
    F.conv2d bitwise and its input, weight and bias gradients autograd's."""
    x, weight, bias, gy, stride = _case(name)
    dw_ref = torch.nn.grad.conv2d_weight(x, weight.shape, gy, stride=stride)
    dw = cw.wgrad(gy, cw.strided_input(x, stride)).reshape(weight.shape)
    assert torch.allclose(dw, dw_ref, rtol=0, atol=1e-13 * float(dw_ref.abs().max()))

    leaves = [x.clone().requires_grad_(), weight.clone().requires_grad_()]
    if bias is not None:
        leaves.append(bias.clone().requires_grad_())
    b = leaves[2] if bias is not None else None
    y_ref = F.conv2d(leaves[0], leaves[1], b, stride, 0, (1, 1))
    grads_ref = torch.autograd.grad(y_ref, leaves, gy)
    y = cw.Conv1x1.apply(leaves[0], leaves[1], b, stride, (1, 1))
    assert torch.equal(y, y_ref)
    grads = torch.autograd.grad(y, leaves, gy)
    for got, ref in zip(grads, grads_ref):
        assert got.shape == ref.shape
        assert torch.allclose(got, ref, rtol=0, atol=1e-13 * float(ref.abs().max()))


def _conv(k=1, dtype=torch.float32, weight_dtype=torch.float32, grad=True):
    conv = layers.Conv(4, 8, (k, k), padding="SAME", dtype=dtype)
    conv.weight = torch.nn.Parameter(conv.weight.detach().to(weight_dtype), requires_grad=grad)
    return conv


CUDA, CPU = torch.device("cuda"), torch.device("cpu")
ROUTES = {
    "1x1 f32 cuda": (lambda: _conv(), CUDA, (0, 0), True, "kernel"),
    "1x1 f32 cpu": (lambda: _conv(), CPU, (0, 0), True, "plain"),
    "3x3 f32 cuda": (lambda: _conv(3), CUDA, (0, 0), True, "plain"),
    "1x1 bf16 compute": (lambda: _conv(dtype=torch.bfloat16), CUDA, (0, 0), True, "plain"),
    "1x1 f64": (lambda: _conv(dtype=torch.float64, weight_dtype=torch.float64), CUDA, (0, 0),
                True, "plain"),
    "1x1 no_grad": (lambda: _conv(), CUDA, (0, 0), False, "plain"),
    "1x1 frozen weight": (lambda: _conv(grad=False), CUDA, (0, 0), True, "plain"),
    "1x1 padded": (lambda: _conv(), CUDA, (1, 1), True, "plain"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_wgrad_route_decides_from_device_dtype_kernel_and_grad_mode(case):
    make, device, padding, grad_mode, want = ROUTES[case]
    with torch.set_grad_enabled(grad_mode):
        assert layers.wgrad_route(make(), device, padding) == want


# Every 1x1 of DeepLabV3-ResNet50 at batch 32, 256^2 (Co, Ci, input side,
# stride), and the UNet's 32 -> 21 head.
DEEPLAB_1X1 = [(64, 64, 64, 1), (256, 64, 64, 1), (64, 256, 64, 1), (128, 256, 64, 1),
               (512, 128, 32, 1), (512, 256, 64, 2), (128, 512, 32, 1), (256, 512, 32, 1),
               (1024, 256, 16, 1), (1024, 512, 32, 2), (256, 1024, 16, 1), (512, 1024, 16, 1),
               (2048, 512, 16, 1), (2048, 1024, 16, 1), (512, 2048, 16, 1), (256, 2048, 16, 1),
               (256, 2048, 1, 1), (256, 1280, 16, 1), (21, 256, 16, 1), (21, 32, 256, 1)]
H100_SMS = 132  # an H100 SXM's streaming multiprocessors


@pytest.mark.parametrize("shape", DEEPLAB_1X1, ids=lambda s: "x".join(map(str, s)))
def test_split_plan_covers_the_reduction_once(shape):
    """Tile sides the kernel is built for, tiles covering Co x Ci, and the
    splits' pixel ranges (whole slabs) covering 0..N*P once, none empty."""
    co, ci, side, stride = shape
    np_ = 32 * ((side - 1) // stride + 1) ** 2
    plan = cw.wgrad_plan(co, ci, np_, H100_SMS)
    assert plan == cw.wgrad_plan(co, ci, np_, H100_SMS)
    assert plan.bm in cw.SIDES and plan.bn in cw.SIDES and plan.bm * plan.bn <= cw.TILE
    assert plan.chunk % cw.SLAB == 0 and 1 <= plan.splits <= 65535
    tiles = -(-co // plan.bm) * -(-ci // plan.bn)
    assert tiles * plan.splits <= max(cw.blocks_per_sm(plan.bm, plan.bn, tiles) * H100_SMS, tiles)
    covered = np.zeros(np_, dtype=np.int64)
    for z in range(plan.splits):
        lo, hi = z * plan.chunk, min((z + 1) * plan.chunk, np_)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()


def test_wrappers_refuse_what_the_kernel_does_not_take():
    x, _, _, gy, _ = _case("expand", dtype=torch.float32)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        cw.wgrad_cuda(gy, x)
    with pytest.raises(ValueError, match="N, Ho and Wo"):
        cw.wgrad(gy, x[:, :, :4])
    with pytest.raises(ValueError, match="Co, Ci and N\\*Ho\\*Wo >= 1"):
        cw.wgrad_plan(0, 4, 16, H100_SMS)
    assert cw.launches == cw.reduce_launches == 0


SMALL_UNET = dict(kernels=((3, 3),) * 3, strides=((1, 1),) + ((2, 2),) * 2)
BACKBONES = {
    "unet2": ("unet2", dict(SMALL_UNET, drop_block=True), 21),
    "unet residual attention": ("unet2", dict(SMALL_UNET, residual=True, attention=True), 21),
    "deeplabv3": ("deeplabv3", dict(base=8, layers=(1, 1, 1, 1), dropout=0.3), 3),
    "enet": ("enet", dict(init_channels=8, dropout=0.3), 3),
    "resnet": ("resnet", dict(layers=(1, 1, 1, 1), dropout=0.3), None),
}


def _step(name, seed=0):
    """A training forward and backward of a small backbone on the CPU:
    the outputs and every parameter's gradient."""
    model_name, kwargs, channels = BACKBONES[name]
    out_shape = (21, 2) if channels is None else (channels, 32, 32)
    model = build_backbone(model_name, (1, 32, 32), out_shape, **kwargs)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    x = torch.randn(2, 1, 32, 32, generator=torch.Generator().manual_seed(seed + 1))
    out = model(x, deterministic=False, generator=torch.Generator().manual_seed(seed + 2))
    tensors = [v for v in out.values() if torch.is_tensor(v)]
    loss = sum((t * torch.linspace(-1, 1, t.numel()).reshape(t.shape)).sum() for t in tensors)
    loss.backward()
    return [t.detach() for t in tensors], {n: p.grad for n, p in model.named_parameters()}


def _parent_forward(self, x, add_bias=True):
    """Conv.forward without the weight gradient route: F.conv2d alone."""
    b = None if self.bias is None or not add_bias else self.bias.to(self.dtype)
    x = x.to(self.dtype)
    padding = self.padding
    if padding == "SAME":
        pads = layers.same_padding(x.shape[2:], self.weight.shape[2:], self.stride,
                                   self.dilation)
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            (top, bottom), (left, right) = pads
            x, padding = F.pad(x, (left, right, top, bottom)), (0, 0)
    return F.conv2d(x, self.weight.to(self.dtype), b, self.stride, padding, self.dilation)


@pytest.mark.parametrize("name", list(BACKBONES))
def test_cpu_training_step_is_bitwise_the_plain_route(name, monkeypatch):
    """On the CPU no convolution takes the kernel route: outputs and every
    gradient equal those of F.conv2d alone, bit for bit."""
    monkeypatch.setattr(cw.Conv1x1, "apply", lambda *a: pytest.fail("routed on the CPU"))
    outs, grads = _step(name)
    monkeypatch.setattr(layers.Conv, "forward", _parent_forward)
    outs_ref, grads_ref = _step(name)
    for got, ref in zip(outs, outs_ref):
        assert torch.equal(got, ref)
    assert grads.keys() == grads_ref.keys()
    for key, ref in grads_ref.items():
        assert (grads[key] is None) == (ref is None), key
        assert ref is None or torch.equal(grads[key], ref), key


@pytest.mark.parametrize("name", list(BACKBONES))
def test_forced_route_on_the_cpu_matches_the_plain_route(name, monkeypatch):
    """With the route forced on the CPU (the Function then runs the plain
    version in the kernel's place), a training step's outputs equal the
    plain route's bit for bit and every gradient agrees within f32
    rounding; DeepLabV3 routes its 2 x 4 + 4 + 3 + 1 1x1s, the UNets their
    head (and the attention gates' 1x1s)."""
    outs_ref, grads_ref = _step(name)
    route = layers.wgrad_route
    routed = []

    def forced(conv, device, padding):
        out = route(conv, torch.device("cuda"), padding)
        routed.append(out == "kernel")
        return out

    monkeypatch.setattr(layers, "wgrad_route", forced)
    outs, grads = _step(name)
    if name == "deeplabv3":
        assert sum(routed) == 16
    assert sum(routed) >= 1
    for got, ref in zip(outs, outs_ref):
        assert torch.equal(got, ref)
    for key, ref in grads_ref.items():
        if ref is None:
            assert grads[key] is None, key
            continue
        assert float((grads[key] - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), key
