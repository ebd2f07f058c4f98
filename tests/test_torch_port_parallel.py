"""PyTorch port vs itself and vs the JAX package: several ranks through
torch.distributed (parallel/distributed.py, parallel/mesh.py,
parallel/serving.py, the data-parallel trainer, the serving modes of
predict.py and the runner).

Two ranks run as two processes on the CPU (gloo, a file:// rendezvous under
the module's tmp directory), spawned once for the module by
`distributed.spawn`: `_rank_checks` runs every multi-rank check there and
returns numpy results, which the cases below read, so each counts. The
children import no JAX: the JAX package runs in this process only, on
`make_mesh(2)` of the CPU devices tests/conftest.py provides, and hands the
children its weights as numpy arrays.

Setting: 64^2 synthetic CAMUS views (8 patients: 6 test views of ED and
ES, 16 training frames), the 4-stage UNet, `torch.set_num_threads(1)` in
every process. Budgets:

- view-parallel serving on two ranks equals one process bitwise, output by
  output, at one view per dispatch and at four (a ragged last dispatch:
  rank 0 serves four views, rank 1 two);
- the latency and composed modes (the forwards whole on every rank, each
  rank rasterizing its share of a view's T_a samples; the segmentation
  predictor post-processing its share of the sample masks): every output
  bitwise one process's, where the JAX package holds its latency mode to
  budgets (tests/test_parallel.py; it also splits the MC-dropout rows);
- three SGD steps of the data-parallel trainer with augmentation and
  dropout on: every parameter within 1e-5 of its leaf's largest value of
  one process's (the order of the gradient sums);
- against the JAX package on `make_mesh(2)` (its weights converted): the
  deterministic outputs of serving (T_e = 1, a fixed logit map added to
  the heatmaps so the untrained UNet gives real contours) at the budgets
  of `_assert_batchresult_equivalence` (mu and cov 1e-4), the sampled ones
  in distribution (other RNG streams; T_a = 128); three SGD steps
  (augmentation and dropout off) at the bar of
  tests/test_torch_port_train_fit.py's one-update test: each update within
  1e-2 of its leaf's largest plus 1e-4 of the largest of all.
"""

import numpy as np
import pytest
import torch

from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch import runner
from contouring_uncertainty_torch.data.synthetic import synthetic_camus_data
from contouring_uncertainty_torch.models.unet import UNet
from contouring_uncertainty_torch.ops.dsnt import logits_to_pixel_gaussians
from contouring_uncertainty_torch.parallel import (
    distributed,
    distributed_initialize,
    make_mesh,
    process_batch_slice,
    replicate,
    shard_batch,
    shard_host_batch,
    sharded_forward,
)
from contouring_uncertainty_torch.sampler import PosteriorShapeModelSampler, fit_shape_prior
from contouring_uncertainty_torch.tasks import DSNTAleatoric, McDropoutUncertainty
from contouring_uncertainty_torch.train import Trainer, TrainerConfig
from contouring_uncertainty_torch.train import trainer as trainer_mod

torch.set_num_threads(1)

SIZE = 64
SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3)
T_E, T_A = 2, 3  # port against port: MC dropout live
T_A_JAX = 128  # port against JAX: T_e = 1, samples compared in distribution
SEED = 3
RUN = ["data=synthetic", "data.image_size=32", "data.n_patients=5",
       "task.model.kernels=[[3,3],[3,3],[3,3]]", "task.model.strides=[[1,1],[2,2],[2,2]]",
       "trainer.max_epochs=1", "trainer.batch_size=4", "task.t_a=3",
       "data.results_processors=[instant_metrics]"]
TRAIN_CFG = dict(batch_size=4, max_epochs=3, lr=0.1, optimizer="sgd", seed=SEED,
                 fast_dev_run=3, save_every=0)


def _data():
    return synthetic_camus_data(n_patients=8, size=SIZE, seed=2)


class _TwoViews:
    """A data source with only the first two test views of another: the
    views of the JAX comparisons (one dispatch of make_mesh(2))."""

    def __init__(self, data):
        self.data, self.data_params = data, data.data_params

    def train_arrays(self, split="train"):
        return self.data.train_arrays(split)

    def predict_views(self, split="test"):
        return list(self.data.predict_views(split))[:2]


def _mc_task(data, **kw):
    return DSNTAleatoric(data_params=data.data_params, t_e=T_E, t_a=T_A,
                         model_kwargs=dict(SMALL, drop_block=True), **kw)


def _model(task, seed=0):
    return task.build_model(device="cpu", generator=torch.Generator().manual_seed(seed))


class Biased(torch.nn.Module):
    """A UNet with a fixed logit map added to its heatmaps: sharp 1.5 px
    blobs at the landmarks of the test frame it is given (found by its
    image), so the untrained UNet gives real contours."""

    def __init__(self, unet, views):
        super().__init__()
        self.unet = unet
        self.imgs = torch.as_tensor(np.concatenate([v["img"] for v in views]))
        contours = np.concatenate([v["contour"] for v in views])
        yy, xx = np.mgrid[0:SIZE, 0:SIZE]
        self.bias = torch.as_tensor((-((xx - contours[..., 0, None, None]) ** 2
                                      + (yy - contours[..., 1, None, None]) ** 2)
                                     / (2 * 1.5 ** 2)).astype(np.float32))

    def forward(self, x, **kw):
        idx = (self.imgs[None] - x[:, None]).abs().sum((2, 3, 4)).argmin(1)
        return {"out": self.unet(x, **kw)["out"] + self.bias[idx]}


def _biased(data, state):
    task = DSNTAleatoric(data_params=data.data_params, t_e=1, t_a=T_A_JAX,
                         model_kwargs=dict(SMALL, drop_block=True))
    unet = task.build_model(device="cpu")
    unet.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return task, Biased(unet, list(data.predict_views("test")))


def _results(results):
    """BatchResults as plain dicts of numpy arrays (picklable, comparable)."""
    keys = ("id", "mu", "cov", "post_mu", "post_cov", "contour_samples", "pred_samples",
            "pred", "uncertainty_map", "entropy_map", "instant_uncertainty",
            "point_uncertainty")
    return [{k: getattr(r, k) for k in keys} for r in results]


def _predict_runs(data, tmp, mesh_for):
    """The serving checks that run alike on one process and on the ranks:
    `mesh_for(s)` gives the mesh (None in one process)."""
    task = _mc_task(data)
    model = _model(task)
    cfg = {"seed": 0, "task": {"psm_path": str(tmp / "psm.npz")}}
    prior = fit_shape_prior(data.train_arrays("train")["contour"])
    view = next(iter(data.predict_views("test")))["img"]
    lat = tpred.AleatoricPredictor(task, model, PosteriorShapeModelSampler(prior, device="cpu"),
                                   device="cpu", mesh=mesh_for(1))
    seg_task = McDropoutUncertainty(data_params=data.data_params, t_e=3,
                                    model_kwargs=dict(SMALL))
    seg = tpred.SegPredictor(seg_task, _model(seg_task), device="cpu", mesh=mesh_for(1))
    return {
        "views_1": _results(tpred.run_predict(task, model, data, cfg, device="cpu",
                                              mesh=mesh_for(1))),
        "views_4": _results(tpred.run_predict(task, model, data,
                                              {**cfg, "predict_batch_views": 4},
                                              device="cpu", mesh=mesh_for(1))),
        "composed": _results(tpred.run_predict(task, model, data, cfg, device="cpu",
                                               mesh=mesh_for(2))),
        "latency": tpred._to_numpy(lat(view, tpred.view_generator(0, 0))),
        "seg_latency": tpred._to_numpy(seg(view, tpred.view_generator(0, 0))),
    }


def _jax_serving(data, state, tmp, mesh):
    """The biased T_e = 1 model served view-parallel (two views) and its
    first view in the latency mode (T_A_JAX samples per frame)."""
    data = _TwoViews(data)
    task, model = _biased(data, state)
    cfg = {"seed": 0, "task": {"psm_path": str(tmp / "psm_biased.npz")}}
    prior = fit_shape_prior(data.train_arrays("train")["contour"])
    lat = tpred.AleatoricPredictor(task, model, PosteriorShapeModelSampler(prior, device="cpu"),
                                   device="cpu", mesh=mesh)
    view = next(iter(data.predict_views("test")))["img"]
    return {"views": _results(tpred.run_predict(task, model, data, cfg, device="cpu",
                                                mesh=mesh)),
            "latency": tpred._to_numpy(lat(view, tpred.view_generator(0, 0)))}


def _fit(data, save_path, augment, drop_block, state=None, steps=3):
    """`steps` SGD steps of the trainer (fast_dev_run), from `state` when
    given; -> (its last weights as numpy, its history, this rank's loss of
    each step)."""
    task = DSNTAleatoric(data_params=data.data_params,
                         model_kwargs=dict(SMALL, drop_block=drop_block))
    trainer = Trainer(task, TrainerConfig(save_path=str(save_path), augment=augment,
                                          name="fit", **{**TRAIN_CFG, "fast_dev_run": steps}),
                      device="cpu")
    if state is not None:
        original = trainer.init_state

        def init_state():
            original()
            trainer.model.load_state_dict(state)

        trainer.init_state = init_state
    losses = []
    step = trainer.train_step

    def train_step(batch, count):
        logs = step(batch, count)
        losses.append(float(logs["loss"]))
        return logs

    trainer.train_step = train_step
    trainer.fit(data.train_arrays("train"), data.train_arrays("val"))
    return ({k: v.numpy().copy() for k, v in trainer.model.state_dict().items()},
            trainer.history, losses)


def _small_unet(seed=0):
    model = UNet(input_shape=(1, 32, 32), output_shape=(5, 32, 32), kernels=((3, 3),) * 3,
                 strides=((1, 1),) + ((2, 2),) * 2)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()


def _forward(model, img):
    with torch.no_grad():
        return logits_to_pixel_gaussians(model(img)["out"])


def _message(fn):
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


def _files(path):
    return sorted(str(p.relative_to(path)) for p in path.rglob("*") if p.is_file()) \
        if path.exists() else []


def _rank_checks(device, tmp, jax_states):
    """Every check on one rank of two (gloo on the CPU) -> numpy results."""
    from pathlib import Path

    torch.set_num_threads(1)
    tmp = Path(tmp)
    rank = distributed.rank()
    out = {"rank": rank, "device": str(device), "world": distributed.world_size(),
           "initialize_again": distributed_initialize(),
           "batch_slice_32": process_batch_slice(32),
           "batch_slice_7": _message(lambda: process_batch_slice(7)),
           "mesh_of_4": _message(lambda: make_mesh(4)),
           "mesh_of_1": _message(lambda: make_mesh(1))}
    mesh = make_mesh(2)
    composed = make_mesh(model_parallel=2)
    out["mesh"] = (mesh.shape, mesh.index("data"), mesh.index("model"))
    out["composed"] = (composed.shape, composed.index("data"), composed.index("model"))
    batch = {"img": np.arange(4 * 3, dtype=np.float32).reshape(4, 3),
             "ragged": np.arange(5, dtype=np.int64), "id": np.array(["a", "b", "c", "d"])}
    out["shard_batch"] = shard_batch(batch, mesh)
    out["shard_host_batch"] = shard_host_batch(batch, mesh)

    model = _small_unet(seed=rank)  # different weights on each rank
    out["replicate_first"] = replicate(model, mesh)
    out["replicate_again"] = replicate(model, mesh)
    out["replicated_weight"] = model.state_dict()["ConvBlock_0.ConvLayer_0.Conv_0.weight"].numpy()
    fn, model = sharded_forward(_forward, _small_unet(seed=rank), mesh)
    img = torch.as_tensor(np.random.default_rng(0).normal(size=(16, 1, 32, 32)),
                          dtype=torch.float32)
    out["sharded_forward"] = tuple(a.numpy() for a in fn(model, img))
    jfn, jmodel = sharded_forward(_forward, _loaded_unet(jax_states["sharded"]), mesh)
    out["sharded_forward_jax_weights"] = tuple(a.numpy() for a in jfn(jmodel, img))
    out["sharded_forward_odd"] = _message(lambda: fn(model, img[:3]))

    data = _data()
    trainer = Trainer(_mc_task(data), TrainerConfig(save_path=str(tmp / "ragged"), **TRAIN_CFG),
                      device="cpu")
    trainer.init_state()
    three = trainer_mod._to_device(next(trainer_mod._iterate(
        data.train_arrays("train"), 3, np.random.default_rng(0))), "cpu")
    out["train_ragged"] = _message(lambda: trainer.train_step(three, 0))
    out["eval_ragged"] = {k: float(v) for k, v in trainer.eval_step(three).items()}
    out["model_axis_trainer"] = _message(lambda: Trainer(
        _mc_task(data), TrainerConfig(**TRAIN_CFG), device="cpu", mesh=composed))

    out["predict"] = _predict_runs(data, tmp, lambda s: make_mesh(model_parallel=s))
    out["jax_serving"] = _jax_serving(data, jax_states["serving"], tmp,
                                      make_mesh())
    out["ddp"] = _fit(data, tmp / f"ddp_rank{rank}", augment=True, drop_block=True)
    out["ddp_files"] = _files(tmp / f"ddp_rank{rank}")
    p0 = {k: torch.as_tensor(v) for k, v in jax_states["train"].items()}
    out["ddp_jax"] = _fit(data, tmp / f"jax_rank{rank}", augment=False, drop_block=False,
                          state=p0)
    out["ddp_jax_one"] = _fit(data, tmp / f"jax1_rank{rank}", augment=False, drop_block=False,
                              state=p0, steps=1)[0]

    runs = {}
    for name, extra in {"auto": [], "false": ["predict_mesh=false"]}.items():
        result = runner.run(RUN + [f"save_path={tmp / ('run_' + name)}",
                                   f"task.psm_path={tmp / ('psm_' + name + '.npz')}", *extra],
                            device=device)
        runs[name] = {"predict": _results(result["predict"]), "test": result["test_metrics"],
                      "history": result["history"],
                      "processor_errors": result.get("processor_errors")}
    out["runs"] = runs
    out["run_files"] = _files(tmp / "run_auto")
    for s in (3, 4):
        where = tmp / f"run_s{s}"
        out[f"run_s{s}"] = _message(lambda: runner.run(
            RUN + [f"save_path={where}", f"predict_sample_parallel={s}"], device=device))
        out[f"run_s{s}_files"] = _files(where)
    return out


def _loaded_unet(state):
    model = _small_unet()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model


# ------------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package on make_mesh(2): the weights it hands the ranks, its
    biased serving, its sharded forward and three SGD steps of its trainer
    on the batches of the port's fit."""
    import jax
    import jax.numpy as jnp

    from contouring_uncertainty_tpu import predict as jpred
    from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
    from contouring_uncertainty_tpu.models import UNet as JUNet
    from contouring_uncertainty_tpu.ops.dsnt import logits_to_pixel_gaussians as j_gauss
    from contouring_uncertainty_tpu.parallel import make_mesh as j_make_mesh
    from contouring_uncertainty_tpu.parallel import shard_batch as j_shard_batch
    from contouring_uncertainty_tpu.parallel import sharded_forward as j_sharded_forward
    from contouring_uncertainty_tpu.tasks import DSNTAleatoric as JTask
    from contouring_uncertainty_tpu.train import Trainer as JTrainer
    from contouring_uncertainty_tpu.train import TrainerConfig as JTrainerConfig
    from contouring_uncertainty_torch.convert import flax_to_torch_state

    tmp = tmp_path_factory.mktemp("jax_side")
    mesh = j_make_mesh(2)
    numpy_state = lambda params: {k: v.numpy() for k, v in flax_to_torch_state(
        jax.tree.map(np.asarray, params)).items()}
    data = _TwoViews(_data())
    views = list(data.predict_views("test"))

    # Serving: the biased T_e = 1 task, view-parallel. (The port's latency
    # mode is held to the same outputs of the first view: JAX's draws are
    # not the port's in either mode, and one compile serves both cases.)
    dp = JDataParams(in_shape=(1, SIZE, SIZE), out_shape=(21, 2))
    jtask = JTask(data_params=dp, t_e=1, t_a=T_A_JAX, model_kwargs=dict(SMALL, drop_block=True))
    junet = jtask.build_model()
    variables = jax.jit(junet.init)(jax.random.key(3), jnp.asarray(views[0]["img"]))
    torch_bias = Biased(torch.nn.Identity(), views)
    imgs, bias = jnp.asarray(torch_bias.imgs.numpy()), jnp.asarray(torch_bias.bias.numpy())

    class JBiased:
        def apply(self, v, x, **kw):
            idx = jnp.argmin(jnp.abs(imgs[None] - x[:, None]).sum((2, 3, 4)), 1)
            return {"out": junet.apply(v, x, **kw)["out"] + bias[idx]}

    jtask.build_model = lambda: JBiased()
    cfg = {"seed": 0, "task": {"psm_path": str(tmp / "psm.npz")}}
    serving = jpred.run_predict(jtask, variables, data, cfg, mesh=mesh)

    # sharded_forward: the 3-stage UNet of the JAX package's own test.
    small = JUNet(input_shape=(1, 32, 32), output_shape=(5, 32, 32),
                  kernels=((3, 3),) * 3, strides=((1, 1),) + ((2, 2),) * 2)
    img = np.random.default_rng(0).normal(size=(16, 1, 32, 32)).astype(np.float32)
    small_vars = jax.jit(small.init)(jax.random.key(0), jnp.asarray(img[:2]))
    jitted, repl = j_sharded_forward(lambda v, x: j_gauss(small.apply(v, x)["out"]),
                                     small_vars, mesh)
    sharded = tuple(np.asarray(a) for a in jitted(repl, jnp.asarray(img)))

    # Three SGD steps on the batches of the port's fit (its `_iterate`).
    jtrain_task = JTask(data_params=dp, model_kwargs=dict(SMALL))
    cfg_keys = {k: v for k, v in TRAIN_CFG.items() if k != "fast_dev_run"}
    jtrainer = JTrainer(jtrain_task, JTrainerConfig(save_path=str(tmp / "trainer"),
                                                    augment=False, name="fit", **cfg_keys),
                        mesh=mesh)
    state = jtrainer.init_state(jax.random.key(SEED))
    p0 = numpy_state(state.params)
    jtrainer._build_steps()
    batches = trainer_mod._iterate(data.train_arrays("train"), TRAIN_CFG["batch_size"],
                                   np.random.default_rng(SEED))
    losses, first = [], None
    for step in range(TRAIN_CFG["fast_dev_run"]):
        state, logs = jtrainer._train_step(state, j_shard_batch(next(batches), mesh),
                                           jax.random.key(SEED), np.uint32(step))
        losses.append(float(logs["loss"]))
        first = numpy_state(state.params) if first is None else first
    return {"states": {"serving": numpy_state(variables["params"]),
                       "sharded": numpy_state(small_vars["params"]), "train": p0},
            "serving": serving, "sharded": sharded, "first_update": first,
            "step_losses": losses}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_side):
    """Rank 0's and rank 1's results of `_rank_checks`."""
    tmp = tmp_path_factory.mktemp("ranks")
    return distributed.spawn(_rank_checks, 2, backend="gloo", init_file=str(tmp / "rendezvous"),
                             args=(str(tmp), jax_side["states"]), devices=["cpu", "cpu"],
                             timeout_s=300, deadline_s=900)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, jax_side):
    """The same runs in this process alone (no mesh)."""
    tmp = tmp_path_factory.mktemp("one_process")
    data = _data()
    img = torch.as_tensor(np.random.default_rng(0).normal(size=(16, 1, 32, 32)),
                          dtype=torch.float32)
    return {"predict": _predict_runs(data, tmp, lambda s: None),
            "jax_serving": _jax_serving(data, jax_side["states"]["serving"], tmp, None),
            "sharded_forward": tuple(a.numpy() for a in _forward(_small_unet(0), img)),
            "ddp": _fit(data, tmp / "ddp", augment=True, drop_block=True)}


# --------------------------------------------------------------------- cases


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    """A single process opens no socket and joins no group: initialize()
    returns False, as the JAX package's does on one host; a process
    group's ranks get True again (`ranks`)."""
    for var in ("CUTPU_COORDINATOR", "RANK", "WORLD_SIZE", "MASTER_ADDR", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    assert distributed_initialize() is False
    assert not torch.distributed.is_initialized()
    assert process_batch_slice(32) == slice(0, 32) and process_batch_slice(7) == slice(0, 7)
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rows(5) == slice(0, 5)


@pytest.mark.parametrize("r", [0, 1])
def test_ranks_join_and_slice_the_batch(ranks, r):
    """Each rank joins the gloo group on the CPU, loads its half of a
    global batch and refuses one that does not divide (JAX's ValueError)."""
    got = ranks[r]
    assert (got["rank"], got["world"], got["device"]) == (r, 2, "cpu")
    assert got["initialize_again"] is True
    assert got["batch_slice_32"] == slice(16 * r, 16 * (r + 1))
    assert got["batch_slice_7"] == "global batch 7 not divisible by 2 hosts"


def test_trainer_refuses_a_ragged_training_batch_and_takes_a_ragged_eval_batch(ranks):
    """The trainer cuts a training batch with process_batch_slice: 3 rows
    on two ranks is JAX's ValueError on both, not the whole batch computed
    twice. A validation batch of 3 goes whole to both ranks (the JAX mesh
    replicates it), so both get the same metrics. A mesh with a model axis
    is refused: the trainer is data parallel over every rank."""
    for got in ranks:
        assert got["train_ragged"] == "global batch 3 not divisible by 2 hosts"
        assert "needs model_parallel=1" in got["model_axis_trainer"]
    assert ranks[0]["eval_ragged"] == ranks[1]["eval_ragged"]
    assert ranks[0]["eval_ragged"] and all(np.isfinite(list(ranks[0]["eval_ragged"].values())))


@pytest.mark.parametrize("r", [0, 1])
def test_make_mesh_lays_out_the_ranks_and_refuses_other_sizes(ranks, r):
    """make_mesh(2) and make_mesh(model_parallel=2) over two ranks; more
    ranks than exist raise as the JAX package's make_mesh raises, and so
    does a mesh smaller than the group."""
    got = ranks[r]
    assert "refusing to silently build a smaller mesh" in got["mesh_of_4"]
    assert "a mesh spans every rank" in got["mesh_of_1"]
    assert got["mesh"] == ({"data": 2, "model": 1}, r, 0)
    assert got["composed"] == ({"data": 1, "model": 2}, 0, r)


@pytest.mark.parametrize("r", [0, 1])
def test_shard_batch_takes_rows_and_replicates_ragged_batches(ranks, r):
    """A batch of 4 rows: each rank its 2; a ragged 5 whole to every rank;
    strings as they are. shard_host_batch on several ranks: each rank's own
    batch as it is."""
    got = ranks[r]["shard_batch"]
    np.testing.assert_array_equal(got["img"], np.arange(12, dtype=np.float32).reshape(4, 3)
                                  [2 * r:2 * r + 2])
    np.testing.assert_array_equal(got["ragged"], np.arange(5))
    assert list(got["id"]) == ["a", "b", "c", "d"]
    np.testing.assert_array_equal(ranks[r]["shard_host_batch"]["img"],
                                  np.arange(12, dtype=np.float32).reshape(4, 3))


def test_replicate_broadcasts_rank_0_and_says_whether_ranks_differed(ranks):
    """Ranks that built different weights: replicate gives both rank 0's
    and answers False on both; a second call answers True."""
    assert [g["replicate_first"] for g in ranks] == [False, False]
    assert [g["replicate_again"] for g in ranks] == [True, True]
    np.testing.assert_array_equal(ranks[0]["replicated_weight"], ranks[1]["replicated_weight"])
    ref = _small_unet(0).state_dict()["ConvBlock_0.ConvLayer_0.Conv_0.weight"].numpy()
    np.testing.assert_array_equal(ranks[1]["replicated_weight"], ref)


@pytest.mark.parametrize("against", ["one_process", "jax"])
def test_sharded_forward_matches(ranks, one_process, jax_side, against):
    """sharded_forward over two ranks (rank 0's weights on both, each rank
    its 8 rows of 16, the outputs all-gathered): on every rank the one
    process forward's mu and sigma within 1e-6; with the JAX package's
    weights, its sharded_forward on make_mesh(2) within its own test's
    budgets (mu 1e-4, sigma 1e-3). A batch of 3 raises JAX's ValueError."""
    for got in ranks:
        assert "batch 3 not divisible by the mesh's 2-way data axis" in got["sharded_forward_odd"]
        if against == "one_process":
            for a, b in zip(got["sharded_forward"], one_process["sharded_forward"]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        else:
            mu, sig = got["sharded_forward_jax_weights"]
            np.testing.assert_allclose(mu, jax_side["sharded"][0], atol=1e-4)
            np.testing.assert_allclose(sig, jax_side["sharded"][1], atol=1e-3)


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif a is None or isinstance(a, str):
        assert a == b, path
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path


@pytest.mark.parametrize("mode", ["views_1", "views_4"])
def test_view_parallel_serving_equals_one_process_bitwise(ranks, one_process, mode):
    """run_predict on make_mesh(2), one view per rank per dispatch
    (views_1) or four (views_4: a dispatch of 6 views, four on rank 0 and
    two on rank 1): rank 0 returns every view in order, each output
    bitwise the one process's; rank 1 returns none."""
    got, ref = ranks[0]["predict"][mode], one_process["predict"][mode]
    assert [g["id"] for g in got] == [r["id"] for r in ref] and len(ref) == 6
    for g, r in zip(got, ref):
        _assert_equal(g, r, g["id"])
    assert ranks[1]["predict"][mode] == []


@pytest.mark.parametrize("r", [0, 1])
def test_latency_mode_matches_one_process(ranks, one_process, r):
    """AleatoricPredictor(mesh=make_mesh(2)) on one view (T_e = 2 MC-dropout
    forwards, T_a = 3 samples per forward, 2 rasterized on rank 0 and 1 on
    rank 1): every rank returns every output of one process bitwise."""
    got, ref = ranks[r]["predict"]["latency"], one_process["predict"]["latency"]
    _assert_equal(got, ref)


def test_composed_mode_matches_one_process(ranks, one_process):
    """run_predict on a 1 x 2 mesh (predict_sample_parallel = 2 of two
    ranks): each view's chain over both ranks; rank 0 returns every view,
    every output bitwise one process's; rank 1 none."""
    got, ref = ranks[0]["predict"]["composed"], one_process["predict"]["views_1"]
    assert [g["id"] for g in got] == [r["id"] for r in ref]
    for g, r in zip(got, ref):
        _assert_equal(g, r, g["id"])
    assert ranks[1]["predict"]["composed"] == []


@pytest.mark.parametrize("r", [0, 1])
def test_segpredictor_latency_mode_matches_one_process(ranks, one_process, r):
    """SegPredictor(mesh=make_mesh(2)), MC dropout at T_e = 3: the
    post-processing of the 3 sample masks per frame split over the ranks
    (2 and 1); every output bitwise one process's."""
    got, ref = ranks[r]["predict"]["seg_latency"], one_process["predict"]["seg_latency"]
    _assert_equal(got, ref)


def _assert_matches_jax(got, ref):
    """Against the JAX package (T_e = 1 biased model, other RNG streams):
    mu within 1e-4 px (_assert_batchresult_equivalence) and cov within 1e-3
    of its scale, the two frameworks' f32 convolutions and moment sums
    rounding apart (the cross-framework bar of
    tests/test_torch_port_batch_views.py; measured 2.3e-4 of 2.7, where
    JAX against itself is held to 1e-4 absolute); post_mu within 5 joint
    standard errors of the T_A_JAX samples; the majority vote equal
    wherever the sample masks' mean occupancy lies more than 5 joint
    binomial standard errors from 0.5 (tests/test_torch_port_batch_views.py)."""
    np.testing.assert_allclose(got["mu"], np.asarray(ref["mu"]), atol=1e-4)
    cov = np.asarray(ref["cov"])
    assert np.abs(got["cov"] - cov).max() < 1e-3 * np.abs(cov).max()
    var_j = np.einsum("...kii->...ki", np.asarray(ref["post_cov"]))
    var_t = np.einsum("...kii->...ki", got["post_cov"])
    assert (np.abs(got["post_mu"] - np.asarray(ref["post_mu"]))
            < 5 * np.sqrt((var_j + var_t) / T_A_JAX)).all()
    assert (np.asarray(ref["pred"]).sum(axis=(-2, -1)) > 100).all()
    occ = [(np.asarray(p["pred_samples"]) > 0).mean(axis=(1, 2)) for p in (got, ref)]
    p = (occ[0] + occ[1]) / 2
    se = np.sqrt(np.maximum(p * (1 - p), 1.0 / T_A_JAX) * 2 / T_A_JAX)
    undecided = np.abs(p - 0.5) <= 5 * se
    assert ((got["pred"] != np.asarray(ref["pred"])) <= undecided).all()


@pytest.mark.parametrize("mode", ["views", "latency"])
def test_serving_on_two_ranks_matches_jax_mesh(ranks, one_process, jax_side, mode):
    """Two ranks against the JAX package's view-parallel run_predict on
    make_mesh(2), two views: the port's view-parallel run_predict (both
    views, rank 0) and its latency mode (the first view, each rank), at
    `_assert_matches_jax`; the two ranks also equal one process of the port
    (bitwise for view-parallel serving)."""
    fields = ("mu", "cov", "post_mu", "post_cov", "pred", "pred_samples")
    ref = [{k: getattr(r, k) for k in fields} for r in jax_side["serving"]]
    if mode == "views":
        got = ranks[0]["jax_serving"]["views"]
        assert [g["id"] for g in got] == [r.id for r in jax_side["serving"]]
        for g, r in zip(got, ref):
            _assert_matches_jax(g, r)
        for g, o in zip(got, one_process["jax_serving"]["views"]):
            _assert_equal(g, o, g["id"])
        assert ranks[1]["jax_serving"]["views"] == []
    else:
        for got in ranks:
            _assert_matches_jax(got["jax_serving"]["latency"], ref[0])
            _assert_equal(got["jax_serving"]["latency"], one_process["jax_serving"]["latency"])


def test_ddp_steps_match_one_process(ranks, one_process):
    """Three SGD steps (lr 0.1, batch 4, augmentation and drop_block on) on
    two ranks, each its two rows of every batch with its rows of the
    batch's augmentation and dropout draws: both ranks end with the same
    weights, every parameter within 1e-5 of its leaf's largest value of one
    process's, plus 1e-6 of the largest weight of all: the conv biases
    ahead of an instance norm have an exact gradient of 0 and hold rounding
    noise of ~1e-7 that no bar relative to themselves can hold; the logged
    losses within 1e-5 relative."""
    (w0, h0, _), (w1, h1, _) = ranks[0]["ddp"], ranks[1]["ddp"]
    ref, href, _ = one_process["ddp"]
    floor = 1e-6 * max(np.abs(r).max() for r in ref.values())
    for name, r in ref.items():
        np.testing.assert_array_equal(w0[name], w1[name], err_msg=name)
        np.testing.assert_allclose(w0[name], r, rtol=0, atol=1e-5 * np.abs(r).max() + floor,
                                   err_msg=name)
    for key in ("train/loss", "val/loss", "val/dice"):
        assert h0[0][key] == h1[0][key], key
        np.testing.assert_allclose(h0[0][key], href[0][key], rtol=1e-5, atol=1e-6, err_msg=key)


def test_ddp_steps_match_the_jax_mesh_trainer(ranks, jax_side):
    """SGD steps (lr 0.1) from the JAX package's initial weights,
    augmentation and dropout off, on two ranks against JAX's Trainer on
    make_mesh(2) fed the same batches: the global loss of each of three
    steps (the mean of the ranks' losses over their rows) within 1e-5
    relative, the logs' bar of tests/test_torch_port_train_fit.py's
    one-update test; and the first update, each leaf within that test's
    bar: 1e-2 of the leaf's largest plus 1e-4 of the largest update of all.

    The weights after three steps are held to one process of the port
    (test_ddp_steps_match_one_process), not to JAX's: at lr 0.1 this
    untrained UNet amplifies a difference in the weights ~25x per step, and
    the two frameworks' f32 convolution gradients start ~6e-3 of a leaf
    apart (one process of the port against JAX's make_mesh(1) measured
    6.3e-3, 0.16 and 0.47 of the worst leaf after one, two and three steps;
    JAX's make_mesh(1) against make_mesh(2) 3.5e-7 absolute after three)."""
    losses = np.mean([g["ddp_jax"][2] for g in ranks], axis=0)
    np.testing.assert_allclose(losses, jax_side["step_losses"], rtol=1e-5)
    p0, ref = jax_side["states"]["train"], jax_side["first_update"]
    got = ranks[0]["ddp_jax_one"]
    floor = 1e-4 * max(np.abs(ref[k] - p0[k]).max() for k in ref)
    for name in ref:
        upd, want = got[name] - p0[name], ref[name] - p0[name]
        np.testing.assert_allclose(upd, want, rtol=0, atol=1e-2 * np.abs(want).max() + floor,
                                   err_msg=name)
        np.testing.assert_array_equal(ranks[1]["ddp_jax_one"][name], got[name], err_msg=name)
    assert floor > 0


def test_only_rank_0_writes_the_run_files(ranks):
    """The trainer's files (best checkpoint, metrics CSV and JSONL, phases,
    train_complete) come from rank 0; rank 1 writes none."""
    assert ranks[1]["ddp_files"] == []
    files = ranks[0]["ddp_files"]
    for want in ("3/fit.ckpt/state.pt", "3/fit_metrics.csv", "3/fit_metrics.jsonl",
                 "3/fit_phases.json", "3/train_complete"):
        assert want in files, (want, files)


def test_runner_serves_view_parallel_with_predict_mesh_auto(ranks):
    """runner.run on two ranks (predict_mesh auto): both train the same
    weights data-parallel and get the same test metrics; rank 0 returns
    every test view and runs the processors without error, rank 1 returns
    none; the run's files are rank 0's."""
    r0, r1 = ranks[0]["runs"]["auto"], ranks[1]["runs"]["auto"]
    untimed = lambda history: [{k: v for k, v in row.items() if k != "time"} for row in history]
    assert untimed(r0["history"]) == untimed(r1["history"]) and r0["test"] == r1["test"]
    assert len(r0["predict"]) == 2 and r1["predict"] == []
    assert r0["processor_errors"] is None and r1["processor_errors"] is None
    assert "results/metrics.json" in ranks[0]["run_files"]


def test_predict_mesh_false_serves_on_rank_0_alone(ranks):
    """runner.run with predict_mesh=false on two ranks: rank 0 serves every
    view alone and rank 1 none, as the JAX runner serves on one device; the
    predictions equal the view-parallel ones of predict_mesh auto bitwise
    (the same trained weights)."""
    r0, r1 = ranks[0]["runs"]["false"], ranks[1]["runs"]["false"]
    assert r1["predict"] == [] and len(r0["predict"]) == 2
    for g, a in zip(r0["predict"], ranks[0]["runs"]["auto"]["predict"]):
        _assert_equal(g, a, g["id"])


@pytest.mark.parametrize("s", [3, 4])
def test_sample_parallel_not_dividing_the_ranks_raises_before_training(ranks, s):
    """predict_sample_parallel = s that does not divide the two ranks:
    runner.run raises the JAX runner's ValueError on every rank before
    anything is trained (no file written)."""
    for got in ranks:
        assert got[f"run_s{s}"] == (f"predict_sample_parallel={s} must divide the device "
                                    "count (2)")
        assert got[f"run_s{s}_files"] == []


def test_runner_main_spawns_a_worker_per_gpu_without_a_deadline(tmp_path, monkeypatch):
    """`runner.main` on a machine with two visible GPUs (the device count
    patched here) starts two workers through `distributed.spawn` and sets
    them no wall-clock deadline: a training run may outlast the
    collectives' timeout (DEFAULT_TIMEOUT_S). The workers run here as two
    gloo ranks on the CPU; rank 0 writes the run's checkpoint."""
    calls = []

    def spawn(fn, world, **kw):
        calls.append((world, dict(kw)))
        return distributed.spawn(fn, world, **{**kw, "backend": "gloo", "deadline_s": 300,
                                               "devices": ["cpu"] * world})

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(runner, "spawn", spawn)
    for var in ("CUTPU_COORDINATOR", "RANK", "WORLD_SIZE", "MASTER_ADDR", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    runner.main(RUN + [f"save_path={tmp_path}", f"task.psm_path={tmp_path / 'psm.npz'}",
                       "trainer.fast_dev_run=1", "test=false", "predict=false"])
    assert [world for world, _ in calls] == [2]
    kw = calls[0][1]
    assert kw.get("deadline_s") is None and kw.get("timeout_s") is None, kw
    assert list(tmp_path.glob("10/*.ckpt/state.pt"))


def _fill_cache_slowly(device, seconds):
    """rank0_first over a fill that takes rank 0 `seconds`; then an
    all-reduce on the default group. -> (this rank's fill, the sum)."""
    import time

    def fill():
        if distributed.rank() == 0:
            time.sleep(seconds)
        return distributed.rank()

    got = distributed.rank0_first(fill)
    total = torch.ones(1)
    torch.distributed.all_reduce(total)
    return got, float(total)


def test_rank0_first_and_spawn_outlast_the_collective_timeout(tmp_path):
    """Two gloo ranks whose collectives time out after 6 s: rank 0 fills
    a cache for 8 s inside rank0_first while rank 1 waits (its barrier is
    not bound by the collectives' timeout), and spawn, given no deadline,
    waits for the run that outlasts it."""
    import time

    t0 = time.monotonic()
    got = distributed.spawn(_fill_cache_slowly, 2, backend="gloo", devices=["cpu", "cpu"],
                            init_file=str(tmp_path / "rendezvous"), args=(8.0,),
                            timeout_s=6.0, deadline_s=120)
    assert got == [(0, 2.0), (1, 2.0)]
    assert time.monotonic() - t0 > 8.0


# A script whose ranks' function lives in its __main__ (as chip_smoke.py's
# do): it spawns two gloo ranks, rank 1 returning, raising or dying as its
# argument says (rank 0 then waits in a barrier), and prints what spawn gave
# and the script's child processes still running afterwards.
SPAWN_SCRIPT = """
import json, os, sys
from pathlib import Path

import torch

from contouring_uncertainty_torch.parallel import distributed


def rank_fn(device, how):
    if distributed.rank() == 1 and how == "raises":
        raise ValueError("rank 1 raises")
    if distributed.rank() == 1 and how == "dies":
        os._exit(7)
    if how != "returns":
        torch.distributed.barrier()
    return distributed.rank()


def children():
    me = str(os.getpid())
    return sorted(p.parent.name for p in Path("/proc").glob("[0-9]*/stat")
                  if p.exists() and p.read_text().rsplit(")", 1)[1].split()[1] == me)


if __name__ == "__main__":
    try:
        got = distributed.spawn(rank_fn, 2, backend="gloo", devices=["cpu", "cpu"],
                                args=(sys.argv[1],), timeout_s=120, deadline_s=120)
    except RuntimeError as exc:
        got = str(exc).splitlines()[0]
    print(json.dumps({"got": got, "children": children()}))
"""


@pytest.mark.parametrize("how,want", [
    ("returns", [0, 1]),
    # rank 0's barrier may fail first, on the connection its peer closed
    ("raises", r"rank [01] of 2 failed:"),
    ("dies", r"rank 1 exited with code 7 without a result|rank 0 of 2 failed:"),
])
def test_spawn_leaves_no_process_running(tmp_path, how, want):
    """However its ranks end, every process `spawn` started has exited and
    been reaped when it returns or raises (a rank left waiting in a
    collective by a failed peer is stopped, not waited for), and a
    function of the caller's main script runs in the ranks."""
    import json
    import os
    import re
    import subprocess
    import sys
    import time
    from pathlib import Path

    script = tmp_path / "spawn_script.py"
    script.write_text(SPAWN_SCRIPT)
    repo = str(Path(__file__).resolve().parents[1])
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")])}
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, str(script), how], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if how == "returns":
        assert out["got"] == want
    else:
        assert re.fullmatch(want, out["got"]), out["got"]
    assert out["children"] == []
    assert time.monotonic() - t0 < 60  # the waiting rank 0 was not waited for


@pytest.mark.parametrize("name", ["unet2", "enet", "deeplabv3", "resnet"])
def test_no_backbone_needs_a_synchronised_batch_norm(name):
    """Every backbone the factory builds normalises per sample (instance
    norm in the UNet, group norm in the others), so data-parallel training
    needs no SyncBatchNorm: none holds a BatchNorm."""
    from contouring_uncertainty_torch.data.config import DataParams

    task = DSNTAleatoric(data_params=DataParams(in_shape=(1, 32, 32), out_shape=(21, 2)),
                         model_name=name,
                         model_kwargs=dict(SMALL) if name == "unet2" else {})
    model = task.build_model(device="cpu")
    norms = [type(m).__name__ for m in model.modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
             or "BatchNorm" in type(m).__name__]
    assert norms == []
