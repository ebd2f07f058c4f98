"""The port's DeepLabV3 (models/deeplabv3.py) against the benchmark's plain
reference of it (portbench/reference/deeplabv3.py), on the CPU at base 8,
64x64, K = 21, on the benchmark's weights (portbench/weights.py) drawn by
the reference's initialisation rule:

- the forward with dropout off (one and two bottlenecks in the second
  stage) and on (the same uniforms fed to both);
- one DSNT-AL training step: the loss and every leaf's gradient;
- the reference's FLOP count against `torch.utils.flop_counter` on the
  port's model, and the published count;
- the initialisation rule against the port's own;
- the model's trace spans (`cut.model.backbone`, `cut.model.aspp`,
  `cut.model.head`) inside the training step's `cut.train.forward`.

Tolerances. The port normalises with single-pass f32 statistics
(E[x^2] - E[x]^2), the reference with `F.group_norm`; through the 20-odd
norms of these depths the logits part by up to 8.8e-6 of their largest
magnitude (measured), so 1e-4 of it, where a wrong padding, dilation,
projection or dropout mask moves them by O(1) (dropout alone: 0.9). The
loss within 1e-5 relative (measured 0) and each gradient leaf within 1e-3
of the larger of its own norm and the median leaf's (measured 1.3e-5).
The median holds the leaves whose exact gradient is zero: ASPP's pooling
branch (its norm sees a 1x1 map, so gives its bias) and the heatmaps'
bias (the softmax ignores it).
"""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from contouring_uncertainty_torch.data.config import DataParams
from contouring_uncertainty_torch.models.deeplabv3 import DeepLabV3
from contouring_uncertainty_torch.models.layers import Conv, InstanceNorm
from contouring_uncertainty_torch.tasks import DSNTAleatoric
from contouring_uncertainty_torch.train import Trainer, TrainerConfig
from contouring_uncertainty_torch.utils import profiling
from portbench import weights, work
from portbench.reference import deeplabv3 as ref
from portbench.reference import head as ref_head

torch.set_num_threads(1)

SIZE, K, SEED = 64, 21, 2 ** 32 + 5
SMALL = {"1111": dict(base=8, layers=[1, 1, 1, 1], dropout=0.1),
         "1211": dict(base=8, layers=[1, 2, 1, 1], dropout=0.1)}


def _model(model):
    return DeepLabV3((1, SIZE, SIZE), (K, SIZE, SIZE), layers=tuple(model["layers"]),
                     base=model["base"], dropout=model["dropout"])


def _weighted(model):
    net = _model(model)
    w = weights.make({n: v.shape for n, v in net.state_dict().items()}, SEED, "cpu", ref.init)
    net.load_state_dict(w)
    return net.eval(), w


def _images(n=4, seed=0):
    return torch.rand(n, 1, SIZE, SIZE, generator=torch.Generator().manual_seed(seed))


def _gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("layers", sorted(SMALL))
def test_forward_matches_reference_dropout_off(layers):
    net, w = _weighted(SMALL[layers])
    x = _images()
    with torch.no_grad():
        got = net(x)["out"]
        want = ref.forward(w, x, SMALL[layers])
    assert got.shape == want.shape == (4, K, SIZE, SIZE)
    assert _gap(got, want) < 1e-4


def test_forward_matches_reference_dropout_on():
    """The port draws its masks from the generator it is given, one
    (B, C, 1, 1) draw a bottleneck in execution order; the reference takes
    the same uniforms from a generator of the same seed. Without the masks
    the logits move by far more than the tolerance."""
    model = SMALL["1211"]
    net, w = _weighted(model)
    x = _images()
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        got = net(x, deterministic=False, generator=torch.Generator().manual_seed(11))["out"]
        want = ref.forward(w, x, model, lambda shape: torch.rand(shape, generator=g))
        plain = ref.forward(w, x, model)
    assert _gap(got, want) < 1e-4
    assert _gap(plain, want) > 1e-2


def test_dsnt_al_step_matches_reference():
    """One DSNT-AL training forward and backward with dropout on: the
    port's task loss (DSNT moments, Gaussian NLL) against the reference's
    head and NLL, and every parameter's gradient."""
    model = SMALL["1211"]
    net, w = _weighted(model)
    task = DSNTAleatoric(data_params=DataParams(in_shape=(1, SIZE, SIZE), out_shape=(K, 2)),
                         model_kwargs=dict(model), model_name="deeplabv3")
    rng = np.random.default_rng(3)
    batch = {"img": _images(seed=1),
             "contour": torch.from_numpy(rng.uniform(8, 56, (4, K, 2)).astype(np.float32))}
    net.train()
    loss, _ = task.loss(net, batch, generator=torch.Generator().manual_seed(7), train=True)
    loss.backward()
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    g = torch.Generator().manual_seed(7)
    logits = ref.forward(params, batch["img"], model, lambda s: torch.rand(s, generator=g))
    mu, cov = ref_head.gaussians(logits, torch.float32)
    want = ref_head.gaussian_nll(mu, cov, batch["contour"]).mean()
    grads = dict(zip(params, torch.autograd.grad(want, list(params.values()))))
    got_loss, want_loss = float(loss.detach()), float(want.detach())
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    norms = {k: float(v.norm()) for k, v in grads.items()}
    median = float(np.median(list(norms.values())))
    got = dict(net.named_parameters())
    assert set(got) == set(grads)
    for name, grad in grads.items():
        gap = float((got[name].grad - grad).norm()) / max(norms[name], median)
        assert gap < 1e-3, (name, gap)


@pytest.mark.parametrize("size,model", [(64, SMALL["1211"]),
                                        (72, dict(base=16, layers=[2, 1, 1, 2], dropout=0.1))],
                         ids=["64px-base8", "72px-base16"])
def test_train_flops_match_flop_counter(size, model):
    """Two images through the port's model on the meta device: the forward's
    count is the reference's convolutions at their output sizes (72 px
    gives odd sizes on the way down), forward and backward its
    `train_flops`."""
    with torch.device("meta"):
        net = DeepLabV3((1, size, size), (K, size, size), layers=tuple(model["layers"]),
                        base=model["base"], dropout=model["dropout"])
    x = torch.empty(2, 1, size, size, device="meta")
    with FlopCounterMode(display=False) as fc:
        net(x)
    assert fc.get_total_flops() == 2 * sum(map(work.conv_flops, ref.convs((1, size, size), K,
                                                                           model)))
    with FlopCounterMode(display=False) as fc:
        net(x)["out"].sum().backward()
    assert fc.get_total_flops() == 2 * ref.train_flops((1, size, size), K, model)


def test_published_counts():
    """The benchmark's configuration at 256x256, K = 21: 39,632,597
    parameters, 24.00 GFLOP forward and 71.89 a training image, the last
    also by `flop_counter` on the port's model."""
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    config = json.loads((repo / "portbench/configs/camus-dsnt-al-deeplabv3.json").read_text())
    model = config["model"]
    assert (model["base"], model["layers"], model["dropout"]) == (64, [3, 4, 6, 3], 0.1)
    with torch.device("meta"):
        net = DeepLabV3((1, 256, 256), (K, 256, 256), layers=tuple(model["layers"]),
                        base=model["base"], dropout=model["dropout"])
    assert sum(p.numel() for p in net.parameters()) == config["published"]["parameters"]
    assert sum(p.numel() for p in net.parameters()) == 39632597
    convs = ref.convs((1, 256, 256), K, model)
    assert round(sum(map(work.conv_flops, convs)) / 1e9, 2) == 24.00
    assert round(ref.train_flops((1, 256, 256), K, model) / 1e9, 2) == 71.89
    with FlopCounterMode(display=False) as fc:
        net(torch.empty(1, 1, 256, 256, device="meta"))["out"].sum().backward()
    assert fc.get_total_flops() == ref.train_flops((1, 256, 256), K, model)


def test_init_rule_is_the_ports_own():
    """Every convolution draws at variance 1 / fan_in, the port's
    `init_scale` over its fan in; every GroupNorm scale is one and every
    bias zero. The drawn weights bear it out."""
    net = _model(SMALL["1211"])
    modules = dict(net.named_modules())
    for name, leaf in net.state_dict().items():
        owner, kind = modules[name.rsplit(".", 1)[0]], name.rsplit(".", 1)[1]
        rule = ref.init(name, leaf.shape)
        if isinstance(owner, Conv) and kind == "weight":
            assert rule == ("normal", owner.init_scale / owner.weight[0].numel()), name
            assert rule[1] == 1.0 / (leaf.shape[1] * leaf.shape[2] * leaf.shape[3])
        elif isinstance(owner, InstanceNorm) and kind == "weight":
            assert rule == ("constant", 1.0), name
        else:
            assert kind == "bias" and rule == ("constant", 0.0), name
    _, w = _weighted(SMALL["1211"])
    for name, leaf in w.items():
        kind, value = ref.init(name, leaf.shape)
        if kind == "constant":
            assert torch.equal(leaf, torch.full_like(leaf, value)), name
    big = w["ASPP_0.Conv_5.weight"]  # 256 x 1280: 327,680 draws
    assert float(big.var()) == pytest.approx(1.0 / 1280, rel=0.02)
    assert float(big.abs().max()) <= 2.0 / 1280 ** 0.5 / weights._TRUNC_STD * (1 + 1e-6)


def _trainer():
    task = DSNTAleatoric(data_params=DataParams(in_shape=(1, SIZE, SIZE), out_shape=(K, 2)),
                         model_kwargs=dict(SMALL["1111"]), model_name="deeplabv3")
    trainer = Trainer(task, TrainerConfig(batch_size=4, seed=3), device="cpu")
    trainer.init_state()
    return trainer


def _batches(n=2):
    rng = np.random.default_rng(0)
    return [{"img": torch.from_numpy(rng.integers(0, 256, (4, 1, SIZE, SIZE), dtype=np.uint8)),
             "contour": torch.from_numpy(rng.uniform(8, 56, (4, K, 2)).astype(np.float32))}
            for _ in range(n)]


MODEL_SPANS = ["cut.model.backbone", "cut.model.aspp", "cut.model.head"]


def test_model_spans_open_inside_the_forward(tmp_path):
    """Under a CPU profiler each train step's `cut.train.forward` holds the
    backbone, ASPP and head spans once each, in that order, on the thread
    of the step."""
    from torch.profiler import ProfilerActivity, profile

    trainer = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i, batch in enumerate(_batches()):
            trainer.train_step(batch, i)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"], e["tid"])
                    for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("cat") == "user_annotation" and e["name"].startswith("cut.")),
                   key=lambda s: s[1])
    forwards = [s for s in spans if s[0] == "cut.train.forward"]
    assert len(forwards) == 2
    assert [s[0] for s in spans if s[0].startswith("cut.model.")] == MODEL_SPANS * 2
    for _, start, end, tid in forwards:
        inside = [s for s in spans if start <= s[1] and s[2] <= end and s[0] != "cut.train.forward"]
        assert [s[0] for s in inside] == MODEL_SPANS
        assert all(s[3] == tid for s in inside)
        assert all(a[2] <= b[1] for a, b in zip(inside, inside[1:]))


def test_no_profiler_opens_no_model_span(monkeypatch):
    """Without a profiler the model's spans are the shared null context: a
    train step reaches `record_function` with no `cut.` name."""
    assert all(profiling.span(name) is profiling._NULL for name in MODEL_SPANS)
    trainer = _trainer()
    original = torch.autograd.profiler.record_function

    def refuse(name, *args, **kwargs):
        assert not name.startswith("cut."), f"record_function({name!r}) with no profiler running"
        return original(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    losses = [float(trainer.train_step(b, i)["loss"]) for i, b in enumerate(_batches())]
    assert np.isfinite(losses).all()
