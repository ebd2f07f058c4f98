"""PyTorch port vs JAX package: the rest of training (train/trainer.py with
a bf16 model and the C++ prefetcher, data/native_loader.py,
csrc/prefetch_loader.cpp, train/logging.py, train/checkpoint.py
`resolve_checkpoint`).

- bf16 (fault F7: the port trained `task.model.dtype=bfloat16` without
  anything holding it against the JAX package): one bf16 train step of
  each package on the same weights and batch, each held to the f64 model;
- the prefetcher: the port's library (its own copy of the source, built
  by build.py) gives the JAX package's batches bitwise, and the port's fit
  draws the JAX fit's batches;
- the loggers' back ends (a fake comet_ml module, the real TensorBoard) and
  the Comet model-registry resolver (a fake API), as
  tests/test_tracking_shims.py holds the JAX package's.
"""

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
from contouring_uncertainty_tpu.data.native_loader import NativePrefetcher as JPrefetcher
from contouring_uncertainty_tpu.tasks import DSNTAleatoric as JTask
from contouring_uncertainty_tpu.train import Trainer as JTrainer
from contouring_uncertainty_tpu.train import TrainerConfig as JTrainerConfig
from contouring_uncertainty_torch import build, runner
from contouring_uncertainty_torch.convert import flax_to_torch_state
from contouring_uncertainty_torch.data import native_loader
from contouring_uncertainty_torch.data.config import DataParams
from contouring_uncertainty_torch.data.native_loader import NativePrefetcher
from contouring_uncertainty_torch.data.synthetic import make_arrays
from contouring_uncertainty_torch.models.layers import conv_output_dtypes, set_compute_dtype
from contouring_uncertainty_torch.models.unet import leaky_relu_sides
from contouring_uncertainty_torch.tasks import DSNTAleatoric
from contouring_uncertainty_torch.train import Trainer, TrainerConfig
from contouring_uncertainty_torch.train.checkpoint import resolve_checkpoint
from contouring_uncertainty_torch.train.logging import ExperimentLogger

torch.set_num_threads(1)

SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3)
DP = dict(in_shape=(1, 64, 64), out_shape=(21, 2))
# One bf16 step against the f64 model (4-stage UNet, 64^2, 4 frames; five
# seeds measured): the loss within 1.3e-3 of f64's (JAX 4.7e-4); the
# gradients' relative L2 error over every leaf 0.14-0.23 in both packages
# (each side within 5% of the other's), because the bf16 forward puts
# ~26,000 of 3.8M activations on the other side of a LeakyReLU kink from
# f64; pinned to the port's own sides the error is 0.024-0.05 (worst leaf
# 0.042-0.065); port against JAX 0.085-0.13. The port's error is held from
# below too (at least 0.8 times JAX's): a port that computed in f32 would
# be nearer f64 than JAX's bf16, and its trunk convolutions are checked to
# emit bf16.
BF16_BARS = {"loss_rel": 5e-3, "grad_l2": 0.35, "grad_l2_vs_jax_ratio": (0.8, 1.25),
             "grad_l2_pinned": 0.1, "leaf_l2_pinned": 0.15, "port_vs_jax": 0.25}


def _l2(a, b, leaves):
    """The relative L2 difference over all `leaves`, and the worst leaf's."""
    num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in leaves)
    den = sum(float((b[n] ** 2).sum()) for n in leaves)
    return (num / den) ** 0.5, max(float((a[n] - b[n]).norm() / b[n].norm()) for n in leaves)


def test_bf16_train_step_matches_jax_and_f64():
    """The F7 gate: a bf16 model (`dtype=bfloat16`: bf16 convolutions,
    f32 parameters, f32 norm statistics, f32 head) takes one train step in
    each package from the same flax weights on the same batch. The losses
    and both gradients are held to the model computing in f64 throughout,
    within BF16_BARS: the port within 0.8-1.25 times JAX's distance from
    f64, and within 0.1 of the f64 gradients pinned to its own LeakyReLU
    sides; every trunk convolution emits bf16 and the head f32. Then
    a Trainer step with AdamW keeps every parameter, gradient and moment in
    f32."""
    img, gt, contour = make_arrays(4, size=64, seed=0)
    batch = {"img": img, "gt": gt, "contour": contour}
    jtask = JTask(data_params=JDataParams(**DP), model_kwargs=dict(SMALL, dtype=jnp.bfloat16))
    jmodel = jtask.build_model()
    variables = jax.jit(jmodel.init)(jax.random.key(1), jnp.asarray(img))
    assert jax.eval_shape(jmodel.apply, variables, jnp.asarray(img))["out"].dtype == jnp.float32

    def jloss(params):
        return jtask.loss(jmodel, {"params": params}, jax.tree.map(jnp.asarray, batch),
                          jax.random.key(0), train=True)

    (jl, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    p0 = flax_to_torch_state(jax.tree.map(np.asarray, variables["params"]))
    task = DSNTAleatoric(data_params=DataParams(**DP), model_kwargs=dict(SMALL, dtype="bfloat16"))
    model = task.build_model(device="cpu")
    model.load_state_dict(p0)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    with leaky_relu_sides(model) as sides, conv_output_dtypes(model) as conv_dtypes:
        loss, _ = task.loss(model, tbatch, train=True)
        loss.backward()
    assert len(conv_dtypes) == 18 and all(
        dt == (torch.float32 if n.startswith("OutputBlock") else torch.bfloat16)
        for n, dt in conv_dtypes.items()), conv_dtypes
    assert model(tbatch["img"])["out"].dtype == torch.float32
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.parameters())

    def f64(pin=None):
        model64 = set_compute_dtype(task.build_model(device="cpu").double(), torch.float64)
        model64.load_state_dict(p0)
        b64 = {k: v.double() if v.is_floating_point() else v for k, v in tbatch.items()}
        with leaky_relu_sides(model64, pin):
            l64 = task.loss(model64, b64, train=True)[0]
            l64.backward()
        return float(l64.detach()), {n: p.grad for n, p in model64.named_parameters()}

    l64, g64 = f64()
    g64_pinned = f64(sides)[1]
    port = {n: p.grad.double() for n, p in model.named_parameters()}
    ref = {n: t.double() for n, t in flax_to_torch_state(jax.tree.map(np.asarray, jgrads)).items()}
    leaves = [n for n in g64 if not n.endswith("Conv_0.bias")]
    assert abs(float(loss) - l64) <= BF16_BARS["loss_rel"] * abs(l64)
    assert abs(float(jl) - l64) <= BF16_BARS["loss_rel"] * abs(l64)
    port_l2, jax_l2 = _l2(port, g64, leaves)[0], _l2(ref, g64, leaves)[0]
    assert port_l2 <= BF16_BARS["grad_l2"] and jax_l2 <= BF16_BARS["grad_l2"]
    low, high = BF16_BARS["grad_l2_vs_jax_ratio"]
    assert low * jax_l2 <= port_l2 <= high * jax_l2, (port_l2, jax_l2)
    pinned, leaf = _l2(port, g64_pinned, leaves)
    assert pinned <= BF16_BARS["grad_l2_pinned"] and leaf <= BF16_BARS["leaf_l2_pinned"]
    assert _l2(port, ref, leaves)[0] <= BF16_BARS["port_vs_jax"]

    trainer = Trainer(task, TrainerConfig(augment=False, seed=1), device="cpu")
    trainer.init_state()
    logs = trainer.train_step(tbatch, 0)
    assert np.isfinite(float(logs["loss"]))
    for p in trainer.model.parameters():
        state = trainer.optimizer.state[p]
        assert p.dtype == p.grad.dtype == torch.float32
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.float32


def _arrays(n=20, size=16, k=5, seed=0, uint8=False):
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 256, size=(n, 1, size, size), dtype=np.uint8) if uint8
           else rng.normal(size=(n, 1, size, size)).astype(np.float32))
    return {"img": img, "gt": rng.integers(0, 3, size=(n, size, size)).astype(np.uint8),
            "contour": rng.normal(size=(n, k, 2)).astype(np.float32)}


@pytest.mark.parametrize("images", ["f32", "uint8"])
def test_prefetcher_batches_are_jax_bitwise(images):
    """The port's NativePrefetcher (its library built by build.py from the
    port's copy of the source into _build/, keyed by its digest) yields the
    JAX package's batches bitwise over two epochs, f32 or uint8 images in
    their own dtype, gt uint8 and contours f32; 3 batches of 6 from 20
    samples (drop_last), each epoch a permutation, the second another."""
    arrays = _arrays(uint8=images == "uint8")
    ours, theirs = NativePrefetcher(arrays, 6, seed=7), JPrefetcher(arrays, 6, seed=7)
    assert native_loader.library_file == build.host_library_path("prefetch_loader")
    assert native_loader.library_file.parent == build.BUILD_DIR
    epochs = []
    for _ in range(2):
        got, ref = list(ours.epoch()), list(theirs.epoch())
        assert len(got) == len(ref) == 3
        for a, b in zip(got, ref):
            assert set(a) == set(b) == {"img", "gt", "contour"}
            for key in a:
                assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
                np.testing.assert_array_equal(a[key], b[key])
        assert got[0]["img"].dtype == (np.uint8 if images == "uint8" else np.float32)
        flat = arrays["img"].reshape(20, -1)
        epochs.append([int(np.flatnonzero((flat == row.ravel()).all(1))[0])
                       for b in got for row in b["img"]])
    ours.close()
    theirs.close()
    assert all(len(set(e)) == 18 for e in epochs) and epochs[0] != epochs[1]


def test_fewer_frames_than_a_batch_is_a_value_error(tmp_path):
    """The prefetcher drops the last partial batch, so 5 training frames
    at batch_size 6 give no batch: NativePrefetcher, and the fit that
    builds one, raise a ValueError naming both numbers (and start no worker
    thread), where an epoch of no steps would fail later."""
    arrays = _arrays(n=5)
    with pytest.raises(ValueError, match="5 training frames cannot fill one batch of 6"):
        NativePrefetcher(arrays, 6)
    task = DSNTAleatoric(data_params=DataParams(in_shape=(1, 16, 16), out_shape=(5, 2)),
                         model_kwargs=dict(kernels=((3, 3),) * 2, strides=((1, 1), (2, 2))))
    trainer = Trainer(task, TrainerConfig(save_path=str(tmp_path), batch_size=6, save_every=0),
                      device="cpu")
    with pytest.raises(ValueError, match="5 training frames"):
        trainer.fit(arrays, arrays)


def test_fit_draws_the_jax_fits_batches(tmp_path, monkeypatch):
    """Without fast_dev_run, the port's fit and the JAX package's fit (their
    steps replaced by recorders) train on the same batches, epoch by epoch:
    the C++ prefetcher's order (seed 3), bitwise, fed through the port's
    device feed; all six from the library, none from the numpy fall-back."""
    rng = np.random.default_rng(2)
    train = {"img": rng.random((14, 1, 32, 32), np.float32),
             "gt": rng.integers(0, 2, (14, 32, 32)).astype(np.uint8),
             "contour": rng.random((14, 21, 2), np.float32) * 32}
    val = {k: v[:4] for k, v in train.items()}
    common = dict(batch_size=4, max_epochs=2, seed=3, save_every=0, name="feed")
    small = dict(kernels=((3, 3),) * 2, strides=((1, 1), (2, 2)))
    jbatches, tbatches = [], []

    def jax_steps(self):
        def train_step(state, batch, rng, step):
            jbatches.append({k: np.asarray(v) for k, v in batch.items()})
            return state, {"loss": jnp.float32(1.0)}

        self._train_step = train_step
        self._eval_step = lambda state, batch: {"loss": jnp.float32(1.0)}

    monkeypatch.setattr(JTrainer, "_build_steps", jax_steps)
    jtask = JTask(data_params=JDataParams(in_shape=(1, 32, 32), out_shape=(21, 2)),
                  model_kwargs=dict(small))
    JTrainer(jtask, JTrainerConfig(save_path=str(tmp_path / "jax"), log_figures=False,
                                   **common)).fit(train, val)

    def train_step(self, batch, step):
        tbatches.append({k: v.numpy() for k, v in batch.items()})
        return {"loss": torch.tensor(1.0)}

    monkeypatch.setattr(Trainer, "train_step", train_step)
    monkeypatch.setattr(Trainer, "eval_step", lambda self, batch: {"loss": torch.tensor(1.0)})
    monkeypatch.setattr(native_loader, "batches_served", 0)
    task = DSNTAleatoric(data_params=DataParams(in_shape=(1, 32, 32), out_shape=(21, 2)),
                         model_kwargs=dict(small))
    trainer = Trainer(task, TrainerConfig(save_path=str(tmp_path / "torch"), log_figures=False,
                                          **common),
                      device="cpu")
    trainer.fit(train, val)
    assert native_loader.batches_served == 6
    assert len(tbatches) == len(jbatches) == 2 * 3
    for a, b in zip(tbatches, jbatches):
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    phases = json.loads((tmp_path / "torch" / "3" / "feed_phases.json").read_text())
    assert phases["data"]["count"] >= 6


# ------------------------------------------------------------ fake comet_ml
class _FakeExperiment:
    def __init__(self, project_name=None):
        self.project_name = project_name
        self.params, self.metrics, self.figures, self.ended = {}, [], [], False

    def log_parameters(self, params):
        self.params.update(params)

    def log_metrics(self, metrics, step=None):
        self.metrics.append((dict(metrics), step))

    def log_figure(self, name, fig, step=None):
        self.figures.append((name, fig, step))

    def end(self):
        self.ended = True


def _fake_comet(experiments, api=None):
    mod = types.ModuleType("comet_ml")
    mod.Experiment = lambda **kw: experiments.append(_FakeExperiment(**kw)) or experiments[-1]
    if api is not None:
        mod.api = types.SimpleNamespace(API=lambda: api)
    return mod


class _FakeWriter:
    instances = []

    def __init__(self, logdir):
        self.logdir, self.scalars, self.figures, self.closed = logdir, [], [], False
        _FakeWriter.instances.append(self)

    def add_scalar(self, key, value, step):
        self.scalars.append((key, value, step))

    def add_figure(self, key, fig, step):
        self.figures.append((key, fig, step))

    def close(self):
        self.closed = True


def test_logger_fans_out_to_comet_and_tensorboard(tmp_path, monkeypatch):
    """With both back ends faked: Comet gets the project, no parameters,
    each metric payload with its step and the end; TensorBoard
    each scalar under <run_dir>/tb; the JSONL file gets every record; a
    figure is saved as figures/{name}_{step}.png and handed to both."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    experiments = []
    monkeypatch.setitem(sys.modules, "comet_ml", _fake_comet(experiments))
    tb_mod = types.ModuleType("torch.utils.tensorboard")
    tb_mod.SummaryWriter = _FakeWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", tb_mod)
    _FakeWriter.instances.clear()
    logger = ExperimentLogger(tmp_path, "run", use_comet=True, use_tensorboard=True)
    logger.log_metrics({"train/loss": 1.5, "val/dice": 0.8, "note": "x"}, step=3)
    fig = plt.figure(figsize=(2, 2))
    logger.log_figure("val_contours", fig, step=3)
    plt.close(fig)
    logger.close()
    assert (tmp_path / "figures" / "val_contours_3.png").stat().st_size > 0
    (exp,) = experiments
    assert exp.figures == [("val_contours", fig, 3)]
    assert exp.project_name == "contouring-uncertainty-tpu" and exp.params == {}
    assert exp.metrics == [({"train/loss": 1.5, "val/dice": 0.8, "note": "x"}, 3)] and exp.ended
    (tb,) = _FakeWriter.instances
    assert tb.logdir == str(tmp_path / "tb") and tb.closed
    assert tb.scalars == [("train/loss", 1.5, 3), ("val/dice", 0.8, 3)]
    assert tb.figures == [("val_contours", fig, 3)]
    record = json.loads((tmp_path / "run_metrics.jsonl").read_text())
    assert record == {"step": 3, "train/loss": 1.5, "val/dice": 0.8, "note": "x"}


def test_logger_real_tensorboard_round_trip(tmp_path):
    """Scalars logged through the real SummaryWriter read back from the
    event file with tensorboard's EventAccumulator."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    logger = ExperimentLogger(tmp_path, "run", use_tensorboard=True)
    assert logger._tb is not None
    logger.log_metrics({"train/loss": 1.25, "val/dice": 0.75}, step=2)
    logger.log_metrics({"train/loss": 0.5}, step=4)
    logger.close()
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert {e.step: e.value for e in acc.Scalars("train/loss")} == \
        {2: pytest.approx(1.25), 4: pytest.approx(0.5)}
    assert {e.step: e.value for e in acc.Scalars("val/dice")} == {2: pytest.approx(0.75)}


def test_logger_backend_failure_falls_back_to_jsonl(tmp_path, monkeypatch, capsys):
    """A Comet back end that fails to start prints why and the JSONL log
    goes on."""
    broken = types.ModuleType("comet_ml")

    def boom(**kw):
        raise RuntimeError("no API key")

    broken.Experiment = boom
    monkeypatch.setitem(sys.modules, "comet_ml", broken)
    logger = ExperimentLogger(tmp_path, "run", use_comet=True)
    logger.log_metrics({"loss": 2.0}, step=0)
    logger.close()
    assert "comet unavailable (no API key); falling back to JSONL" in capsys.readouterr().out
    assert '"loss": 2.0' in (tmp_path / "run_metrics.jsonl").read_text()


def test_runner_with_comet_and_tensorboard(tmp_path, capsys):
    """runner.run with `comet=true tensorboard=true` where comet_ml is not
    installed: the run trains, says Comet is unavailable, and writes the
    JSONL log and TensorBoard's event file with the epoch's train/loss."""
    import importlib.util

    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    assert importlib.util.find_spec("comet_ml") is None
    result = runner.run(["data=synthetic", "data.image_size=32", "data.n_patients=5",
                         "task.model.kernels=[[3,3],[3,3]]", "task.model.strides=[[1,1],[2,2]]",
                         "trainer.fast_dev_run=2", "trainer.batch_size=4", "comet=true",
                         "tensorboard=true", "test=false", "predict=false",
                         f"save_path={tmp_path}"], device="cpu")
    assert "ckpt_path" in result
    assert "comet unavailable" in capsys.readouterr().out
    (jsonl,) = tmp_path.rglob("*_metrics.jsonl")
    records = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert records and "train/loss" in records[0]
    acc = EventAccumulator(str(jsonl.parent / "tb"))
    acc.Reload()
    assert [e.value for e in acc.Scalars("train/loss")] == \
        [pytest.approx(records[0]["train/loss"])]


# ------------------------------------------------------ fake registry resolver
class _FakeAPI:
    """comet_ml.api.API double: lists versions and downloads a port
    checkpoint directory (state.pt, meta.json)."""

    def __init__(self, versions, fail_download=False):
        self.versions, self.fail_download, self.downloads = versions, fail_download, []

    def get_registry_model_versions(self, workspace, registry_name):
        return list(self.versions)

    def download_registry_model(self, workspace, registry_name, version=None, stage=None,
                                output_path=None):
        self.downloads.append(dict(workspace=workspace, registry=registry_name,
                                   version=version, stage=stage))
        if self.fail_download:
            raise RuntimeError("download failed")
        ckpt = Path(output_path) / "model.ckpt"
        ckpt.mkdir(parents=True)
        torch.save({"params": {}}, ckpt / "state.pt")
        (ckpt / "meta.json").write_text('{"task_name": "dsnt-al"}')


@pytest.fixture()
def registry(tmp_path, monkeypatch):
    monkeypatch.setenv("CUTPU_HOME", str(tmp_path / "cache"))

    def install(api):
        monkeypatch.setitem(sys.modules, "comet_ml", _fake_comet([], api=api))
        return api

    return install


def test_resolver_latest_version_semver_sort_and_cache(registry):
    """The latest version by parsed semver (1.10.0 over 1.9.0), downloaded
    once into $CUTPU_HOME/<workspace>/<registry>/<version>; the second
    query reads the cache."""
    api = registry(_FakeAPI(versions=["1.2.0", "1.10.0", "1.9.0"]))
    path = resolve_checkpoint("ws/model")
    assert api.downloads == [dict(workspace="ws", registry="model", version="1.10.0",
                                  stage=None)]
    assert (path / "state.pt").exists() and path.parent.name == "1.10.0"
    assert resolve_checkpoint("ws/model") == path and len(api.downloads) == 1
    assert resolve_checkpoint("ws/model/2").parent.name == "2"
    assert api.downloads[-1]["version"] == "2"


def test_resolver_refuses_dotted_versions_as_jax_does(registry):
    """A version with dots ('ws/model/1.2.0') has a path suffix ('.0'), and
    the JAX resolver takes every suffixed path for a local one: it raises
    FileNotFoundError without asking the registry. The port keeps that
    grammar (ROADMAP.md Queue 3 lists it)."""
    from contouring_uncertainty_tpu.train.checkpoint import resolve_checkpoint as jresolve

    api = registry(_FakeAPI(versions=["1.2.0"]))
    for fn in (resolve_checkpoint, jresolve):
        with pytest.raises(FileNotFoundError, match="registry query"):
            fn("ws/model/1.2.0")
    assert api.downloads == []


def test_resolver_stage_query_always_refreshes(registry):
    api = registry(_FakeAPI(versions=["1.0.0"]))
    assert resolve_checkpoint("ws/model/prod") == resolve_checkpoint("ws/model/prod")
    assert [d["stage"] for d in api.downloads] == ["prod", "prod"]
    assert all(d["version"] is None for d in api.downloads)


def test_resolver_failed_refresh_keeps_cache(registry):
    registry(_FakeAPI(versions=["1.0.0"]))
    marker = resolve_checkpoint("ws/model/prod") / "meta.json"
    registry(_FakeAPI(versions=["1.0.0"], fail_download=True))
    with pytest.raises(RuntimeError, match="download failed"):
        resolve_checkpoint("ws/model/prod")
    assert marker.exists()


def test_resolver_empty_registry_and_local_paths(registry, tmp_path, monkeypatch):
    """An empty registry raises the JAX package's message; a missing path
    that is not a query raises FileNotFoundError; a query without comet_ml
    raises RuntimeError; an existing directory resolves to itself."""
    registry(_FakeAPI(versions=[]))
    with pytest.raises(RuntimeError, match="has no versions; nothing to download"):
        resolve_checkpoint("ws/empty")
    for missing in (tmp_path / "nope.ckpt", "a/b/c/d", "model.ckpt"):
        with pytest.raises(FileNotFoundError, match="registry query"):
            resolve_checkpoint(missing)
    assert resolve_checkpoint(tmp_path) == tmp_path
    monkeypatch.setitem(sys.modules, "comet_ml", None)
    with pytest.raises(RuntimeError, match="comet_ml is not installed"):
        resolve_checkpoint("ws/model")
