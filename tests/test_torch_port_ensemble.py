"""PyTorch port vs JAX package: deep ensembles (tasks/dsnt_al.py and
tasks/dsnt_skew.py `predict` with a list of members, predict.py serving a
member list, runner.py `task.train_ensemble` and ensemble directories).

The members are the JAX package's flax weights (one init key each),
converted with convert.flax_to_torch_state, so both packages serve the same
members on the same numpy views. A member's forward is deterministic, so
the means, covariances and skews are compared value by value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu import predict as jpred
from contouring_uncertainty_tpu import runner as jrunner
from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
from contouring_uncertainty_tpu.tasks import DSNTAleatoric as JAleatoric
from contouring_uncertainty_tpu.tasks.dsnt_skew import DSNTSkew as JSkew
from contouring_uncertainty_tpu.tasks.epistemic import EpistemicUncertainty as JEpistemic
from contouring_uncertainty_tpu.tasks.segmentation import McDropoutUncertainty as JMcDropout
from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch import runner
from contouring_uncertainty_torch.convert import flax_to_torch_state
from contouring_uncertainty_torch.data.config import DataParams
from contouring_uncertainty_torch.data.synthetic import make_arrays
from contouring_uncertainty_torch.tasks import (
    DSNTAleatoric,
    DSNTSkew,
    EpistemicUncertainty,
    McDropoutUncertainty,
)
from contouring_uncertainty_torch.train.checkpoint import save_checkpoint

torch.set_num_threads(1)

SIZE = 64
SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3)
TASKS = {"dsnt-al": (JAleatoric, DSNTAleatoric), "dsnt-skew": (JSkew, DSNTSkew),
         "epistemic": (JEpistemic, EpistemicUncertainty)}
# Member forwards of the two packages on the same weights (f32, CPU):
# mu in px, cov relative to its scale (measured 1.9e-5 px and 1.5e-6).
BARS = {"mu_px": 1e-4, "cov_rel": 1e-4}
RUN = ["data=synthetic", "data.image_size=32", "data.n_patients=5",
       "task.model.kernels=[[3,3],[3,3]]", "task.model.strides=[[1,1],[2,2]]",
       "trainer.batch_size=4", "trainer.max_epochs=1", "trainer.augment=false", "task.t_a=3"]


class _Frames:
    """A data source of synthetic frames at SIZE^2: 12 training frames and
    two test views of an (ED, ES) pair each."""

    data_params = DataParams(in_shape=(1, SIZE, SIZE), out_shape=(21, 2))

    def __init__(self):
        self.img, self.gt, self.contour = make_arrays(16, size=SIZE, seed=1)

    def train_arrays(self, split="train"):
        return {"img": self.img[:12], "gt": self.gt[:12], "contour": self.contour[:12]}

    def predict_views(self, split="test"):
        for v, start in enumerate((12, 14)):
            sl = slice(start, start + 2)
            yield {"id": f"view{v}", "img": self.img[sl], "gt": self.gt[sl],
                   "contour": self.contour[sl], "instants": {"ED": 0, "ES": 1}}


@pytest.fixture(scope="module")
def data():
    return _Frames()


@pytest.fixture(scope="module")
def members():
    """Per task: the JAX task, its flax model and two members' variables,
    the port's task and the two members converted (epistemic shares
    DSNT-AL's UNet and so its members)."""
    out = {}
    img = jnp.zeros((2, 1, SIZE, SIZE))
    for name, (jcls, tcls) in TASKS.items():
        jtask = jcls(data_params=JDataParams(in_shape=(1, SIZE, SIZE), out_shape=(21, 2)),
                     model_kwargs=dict(SMALL))
        jmodel = jtask.build_model()
        if name == "epistemic":
            variables = out["dsnt-al"][2]
        else:
            init = jax.jit(jmodel.init)
            variables = [init(jax.random.key(seed), img) for seed in (3, 4)]
        task = tcls(data_params=DataParams(in_shape=(1, SIZE, SIZE), out_shape=(21, 2)),
                    model_kwargs=dict(SMALL))
        models = []
        for v in variables:
            model = task.build_model(device="cpu")
            model.load_state_dict(flax_to_torch_state(jax.tree.map(np.asarray, v["params"])))
            models.append(model.eval())
        out[name] = (jtask, jmodel, variables, task, models)
    return out


def _close(got_mu, got_cov, ref_mu, ref_cov):
    mu_err = float(np.abs(got_mu - ref_mu).max())
    scale = np.abs(ref_cov).max()
    cov_err = float(np.abs(got_cov - ref_cov).max() / scale)
    assert mu_err <= BARS["mu_px"] and cov_err <= BARS["cov_rel"], (mu_err, cov_err)


@pytest.mark.parametrize("name", list(TASKS))
def test_ensemble_predict_matches_jax(name, members, data):
    """task.predict with a list of two members against the JAX task's
    list-of-variables predict on one view (N=2): mu (N, 2, K, 2), cov
    (N, 2, K, 2, 2) and, for dsnt-skew, alpha within BARS, sample e from
    member e (each slice equals that member alone at T_e=1); epistemic's
    covariances are exactly 0."""
    jtask, jmodel, variables, task, models = members[name]
    img = next(iter(data.predict_views("test")))["img"]
    ref = [np.asarray(a) for a in jtask.predict(jmodel, variables, jnp.asarray(img))]
    with torch.inference_mode():
        got = [a.numpy() for a in task.predict(models, torch.as_tensor(img))]
        alone = [[a.numpy() for a in task.predict(m, torch.as_tensor(img))] for m in models]
    assert len(got) == len(ref) == (3 if name == "dsnt-skew" else 2)
    assert got[0].shape == ref[0].shape == (2, 2, 21, 2)
    assert got[1].shape == ref[1].shape == (2, 2, 21, 2, 2)
    _close(got[0], got[1] if name != "epistemic" else got[0][..., None],
           ref[0], ref[1] if name != "epistemic" else ref[0][..., None])
    if name == "epistemic":
        assert not got[1].any() and not ref[1].any()
    if name == "dsnt-skew":
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-4, atol=1e-5)
    for e, one in enumerate(alone):
        for a, b in zip(got, one):
            np.testing.assert_array_equal(a[:, e], b[:, 0])


def test_ensemble_batched_views_match_jax(members, data, tmp_path):
    """run_predict with two members and predict_batch_views=2: each view's
    fused mu and cov against the JAX package's fusion of its ensemble
    predict within BARS and against one view per dispatch within the JAX
    package's view-batching budgets (mu 1e-5, cov 1e-4); T_e = 2 in the
    sample populations."""
    jtask, jmodel, variables, task, models = members["dsnt-al"]
    cfg = {"seed": 2, "task": {"psm_path": str(tmp_path / "psm.npz")}}
    batched = tpred.run_predict(task, models, data, {**cfg, "predict_batch_views": 2},
                                device="cpu")
    single = tpred.run_predict(task, models, data, cfg, device="cpu")
    assert len(batched) == len(single) == 2
    for view, res, one in zip(data.predict_views("test"), batched, single):
        mu_te, cov_te = jtask.predict(jmodel, variables, jnp.asarray(view["img"]))
        ref_mu, ref_cov = (np.asarray(a) for a in jpred.fuse_epistemic_aleatoric(mu_te, cov_te))
        _close(res.mu, res.cov, ref_mu, ref_cov)
        assert res.contour_samples.shape == (2, 2, task.t_a, 21, 2)
        assert res.pred_samples.shape == (2, 2, task.t_a, SIZE, SIZE)
        np.testing.assert_allclose(res.mu, one.mu, rtol=0, atol=1e-5)
        np.testing.assert_allclose(res.cov, one.cov, rtol=0, atol=1e-4)


def test_train_ensemble_layout_matches_jax_and_serves(tmp_path):
    """Both runners with task.train_ensemble=2 (one fast_dev_run epoch per
    member, 2 stages at 32^2) write the same directory: `<seed>/<name>_ensemble/member_0.ckpt`
    and `member_1.ckpt`, each a checkpoint of its package with the task's
    meta; `ckpt_path` is that directory and `history` the last member's.
    The port then serves the two members (T_e = 2, no processor error), and
    an eval-only run on the directory serves exactly what a direct
    run_predict on the loaded members does."""
    common = RUN + ["task.train_ensemble=2", "trainer.fast_dev_run=1", "seed=6",
                    f"data.dataset_path={tmp_path / 'synth.h5'}"]
    jres = jrunner.run(common + [f"save_path={tmp_path / 'jax'}", "test=false",
                                 "predict=false"])
    res = runner.run(common + [f"save_path={tmp_path / 'torch'}",
                               f"task.psm_path={tmp_path / 'psm.npz'}",
                               "data.results_processors=[instant_metrics]"], device="cpu")
    jdir, tdir = (tmp_path / "jax", tmp_path / "torch")
    assert jres["ckpt_path"].replace(str(jdir), "") == res["ckpt_path"].replace(str(tdir), "")
    ens = tdir / "6" / "synthetic_dsnt-al-unet2-False_6_ensemble"
    assert res["ckpt_path"] == str(ens)
    for root, state in ((jdir, "state"), (tdir, "state.pt")):
        found = sorted(p.relative_to(root).as_posix() for p in root.glob("6/*_ensemble/*"))
        assert found == ["6/synthetic_dsnt-al-unet2-False_6_ensemble/member_0.ckpt",
                         "6/synthetic_dsnt-al-unet2-False_6_ensemble/member_1.ckpt"]
        for member in root.glob("6/*_ensemble/*"):
            assert (member / state).exists() and (member / "meta.json").exists()
    assert len(res["history"]) == len(jres["history"]) == 1
    assert "processor_errors" not in res
    for view in res["predict"]:
        assert view.contour_samples.shape == (2, 2, 3, 21, 2)
        assert np.isfinite(view.mu).all() and np.isfinite(view.cov).all()

    evaluated = runner.run(RUN + [f"data.dataset_path={tmp_path / 'synth.h5'}", "seed=6",
                                  "train=false", f"weights={ens}", "test=false",
                                  f"save_path={tdir}", f"task.psm_path={tmp_path / 'psm.npz'}",
                                  "data.results_processors=[instant_metrics]"], device="cpu")
    loaded = runner.load_weights(_task(res["cfg"]), ens, torch.device("cpu"))
    assert isinstance(loaded, list) and len(loaded) == 2
    direct = tpred.run_predict(_task(res["cfg"]), loaded, _data(res["cfg"]),
                               {"seed": 6, "task": {"psm_path": str(tmp_path / "psm.npz")}},
                               device="cpu")
    for a, b, c in zip(evaluated["predict"], direct, res["predict"]):
        for key in ("mu", "cov", "contour_samples", "pred_samples", "uncertainty_map"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)
        np.testing.assert_array_equal(a.mu, c.mu)


def _task(cfg):
    from contouring_uncertainty_torch import factory

    return factory.build_task(cfg, _data(cfg).data_params)


def _data(cfg):
    from contouring_uncertainty_torch import factory

    return factory.build_data(cfg)


def test_member_order_is_the_jax_runners(tmp_path):
    """A directory of eleven members loads in `sorted(glob("*.ckpt"))`
    order, the JAX runner's: lexicographic, member_10 after member_1; a
    checkpoint directory with `state.pt` loads as one model."""
    task = DSNTAleatoric(data_params=DataParams(in_shape=(1, 32, 32), out_shape=(21, 2)),
                         model_kwargs=dict(kernels=((3, 3),) * 2, strides=((1, 1), (2, 2))))
    model = task.build_model(device="cpu")
    first = next(iter(model.state_dict()))
    for i in range(11):
        state = {k: v.clone() for k, v in model.state_dict().items()}
        state[first].fill_(float(i))
        save_checkpoint(tmp_path / "ens" / f"member_{i}.ckpt", {"params": state})
    loaded = runner.load_weights(task, tmp_path / "ens", torch.device("cpu"))
    order = [int(m.state_dict()[first].flatten()[0]) for m in loaded]
    jax_order = [int(p.stem.split("_")[1]) for p in sorted((tmp_path / "ens").glob("*.ckpt"))]
    assert order == jax_order == [0, 1, 10, 2, 3, 4, 5, 6, 7, 8, 9]
    one = runner.load_weights(task, tmp_path / "ens" / "member_7.ckpt", torch.device("cpu"))
    assert not isinstance(one, list) and float(one.state_dict()[first].flatten()[0]) == 7.0


def test_segmentation_task_refuses_a_member_list(data):
    """A segmentation baseline given a member list: the JAX package fails
    inside flax (a list is not a variables dict); the port raises a
    ValueError naming the task."""
    dp = dict(in_shape=(1, SIZE, SIZE), out_shape=(2, SIZE, SIZE))
    jtask = JMcDropout(data_params=JDataParams(**dp), model_kwargs=dict(SMALL))
    jmodel = jtask.build_model()
    img = jnp.zeros((2, 1, SIZE, SIZE))
    v = jax.eval_shape(jmodel.init, jax.random.key(0), img)
    with pytest.raises(AttributeError):
        jtask.predict_probs(jmodel, [v, v], img, jax.random.key(1))
    task = McDropoutUncertainty(data_params=DataParams(**dp), model_kwargs=dict(SMALL))
    models = [task.build_model(device="cpu") for _ in range(2)]
    with pytest.raises(ValueError, match="'mcdropout' takes one model"):
        tpred.run_predict(task, models, data, {"seed": 0}, device="cpu")
