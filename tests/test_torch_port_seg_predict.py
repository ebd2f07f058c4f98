"""PyTorch port vs JAX package: serving the segmentation baselines
(predict.py `SegPredictor`, `run_predict_segmentation` and `run_predict`'s
dispatch), the epistemic contour task (tasks/epistemic.py, served by
`AleatoricPredictor`), the results processors on segmentation results, and
`runner.run(device="cpu")` for every new task.

Weights are the port's, seeded, put on the flax tree (4-stage UNets at
64^2, `make_pair` of tests/test_torch_port_segmentation.py). Both packages
get the same draws: the aleatoric eps, TTA's augmentation parameters and
SSN's eps_f and eps_d are the JAX task's own draws from the view's key,
handed to the port in place of its generator draws; MC-dropout masks are
read off the JAX forward (which channels each flax Dropout zeroed, in call
order) and handed to the port's dropout as its uniforms.

Budgets, the card-vs-CPU bars of chip_smoke.py [12]: probabilities within
1e-4; at most 8 `pred` pixels per view differ, each at a mean probability
within 1e-3 of 0.5 (binary); sample populations and entropy maps within
1e-4 where the sample masks agree. Epistemic: mu within 1e-3 px, the
covariances exactly 0 before fusion and the fused covariance within 1e-5
of the f64 spread of the means. The processors' values equal to JAX's, or
within 1e-5 + 5e-5 * |value| downstream of the clinical f32 reductions
(tests/test_torch_port_results.py).
"""

from functools import partial

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu import predict as jpredict
from contouring_uncertainty_tpu.data import augment as jaug
from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
from contouring_uncertainty_tpu.tasks import segmentation as jseg
from contouring_uncertainty_tpu.tasks.epistemic import EpistemicUncertainty as JEpistemic
from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch import runner
from contouring_uncertainty_torch.data import augment as taug
from contouring_uncertainty_torch.data.config import BatchResult, DataParams
from contouring_uncertainty_torch.data.synthetic import synthetic_camus_data
from contouring_uncertainty_torch.models import layers as tlayers
from contouring_uncertainty_torch.results import run_processors
from contouring_uncertainty_torch.rng import RowBlock
from contouring_uncertainty_torch.sampler import PosteriorShapeModelSampler, fit_shape_prior
from contouring_uncertainty_torch.tasks import segmentation as tseg
from contouring_uncertainty_torch.tasks.epistemic import EpistemicUncertainty
from test_torch_port_results import _close, run_jax_processors
from test_torch_port_segmentation import SMALL, Draws, _batch, make_pair

torch.set_num_threads(1)

T_E, T_A = 2, 3
TASKS = {
    "mcdropout": (jseg.McDropoutUncertainty, tseg.McDropoutUncertainty,
                  dict(SMALL, drop_block=True), dict(t_e=T_E, t_a=1)),
    "aleatoric": (jseg.AleatoricUncertainty, tseg.AleatoricUncertainty, SMALL, dict(t_a=T_A)),
    "tta": (jseg.TTAUncertainty, tseg.TTAUncertainty, SMALL, dict(t_a=T_A)),
    "ssn": (jseg.StochasticSegmentationNetwork, tseg.StochasticSegmentationNetwork, SMALL,
            dict(t_a=T_A, rank=2)),
}
PROCESSORS = ["instant_metrics", "calibration", "mutual_info", "clinical_metrics"]


def capture_masks(fn):
    """fn jitted, returning (its result, and per flax Dropout call that was
    not deterministic the (B, C) channels it kept, in call order), as numpy."""

    def traced(*a):
        masks = []

        def interceptor(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.Dropout) and not kwargs.get("deterministic", True):
                masks.append(jnp.any(out != 0, axis=(1, 2)))
            return out

        with fnn.intercept_methods(interceptor):
            return fn(*a), masks

    jitted = jax.jit(traced)

    def call(*args):
        result, masks = jitted(*args)
        return jax.tree.map(np.asarray, result), [np.asarray(m) for m in masks]

    return call


def masks_as_uniforms(masks):
    """Stands in for rng.draw_uniform in models/layers.py: uniforms that keep
    exactly the channels of the next captured mask. The row blocks of an
    MC-dropout forward (an `rng.RowBlock` each, tasks/dsnt_al.py
    `mc_dropout_apply`) run one after another: each block takes, in order,
    its rows of the captured masks, the block of rows [r, ...) from the
    mask after the last one a block of rows [r, ...) took."""
    masks, taken = list(masks), {}

    def draw(generators, shape, dtype=torch.float32, device=None):
        rows = generators.rows if isinstance(generators, RowBlock) else slice(0, shape[0])
        i = taken.get(rows.start, 0)
        taken[rows.start] = i + 1
        keep = masks[i][rows]
        assert tuple(shape) == (*keep.shape, 1, 1), (shape, keep.shape)
        return torch.as_tensor(np.where(keep, 0.0, 1.0).reshape(shape), dtype=dtype,
                               device=device)

    return draw


def jax_view_draws(name, jtask, key, n, shape):
    """What the JAX task draws from one view's key: the values the port's
    draw sites then return for that view."""
    if name == "aleatoric":
        return [np.asarray(jax.random.normal(key, (jtask.t_a, n, *shape)))]
    if name == "ssn":
        k1, k2 = jax.random.split(key)
        d = int(np.prod(shape))
        return [np.asarray(jax.random.normal(k1, (jtask.t_a, n, jtask.rank))),
                np.asarray(jax.random.normal(k2, (jtask.t_a, n, d)))]
    if name == "tta":
        params = [jaug.sample_params(k, n) for k in jax.random.split(key, jtask.t_a)]
        return [np.concatenate([np.asarray(p[i]) for p in params]) for i in range(5)]
    return []


def port_draws(name, per_view, monkeypatch):
    """Hand the port, view after view, the JAX draws of `per_view`."""
    if name in ("aleatoric", "ssn"):
        monkeypatch.setattr(tseg, "draw_normal", Draws(
            *(np.stack([v[i] for v in per_view]) for i in range(len(per_view[0])))))
    elif name == "tta":
        def params(generators, views, t_a, n, device):
            return taug.AugmentParams(*(torch.as_tensor(np.concatenate([v[i] for v in per_view]))
                                        for i in range(5)))
        monkeypatch.setattr(tseg, "tta_params", params)


@pytest.fixture(scope="module")
def imgs():
    a = _batch(1, n=4, seed=5)["img"]
    return a.reshape(2, 2, 1, 64, 64)  # two views of (ED, ES)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("name", list(TASKS))
def test_seg_predictor_matches_jax(name, channels, imgs, monkeypatch):
    """SegPredictor of each baseline, binary and 3-class, one view per
    dispatch (V=1) and both views in one (V=2), against the JAX
    SegPredictor and predict_probs with the same weights and draws, within
    the budgets of the module docstring."""
    jcls, tcls, kwargs, task_kwargs = TASKS[name]
    jtask, jmodel, variables, task, model = make_pair(jcls, tcls, channels, kwargs,
                                                      **task_kwargs)
    jpred = jpredict.SegPredictor(jtask, jmodel)
    keys = [jax.random.fold_in(jax.random.key(3), v) for v in range(2)]
    shape = (channels, 64, 64)
    refs, probs_ref, masks, draws = [], [], [], []
    predict_probs = capture_masks(partial(jtask.predict_probs, jmodel))
    for img, key in zip(imgs, keys):
        probs, m = predict_probs(variables, jnp.asarray(img), key)
        with monkeypatch.context() as mp:  # JAX's post-processing of those probabilities
            mp.setattr(jtask, "predict_probs", lambda *args, **kwargs: jnp.asarray(probs))
            refs.append(jax.tree.map(np.asarray, jpred._view_fn(variables, jnp.asarray(img),
                                                                key)))
        probs_ref.append(probs)
        masks += m
        draws.append(jax_view_draws(name, jtask, key, 2, shape))
    assert (len(masks) > 0) == (name == "mcdropout")
    predictor = tpred.SegPredictor(task, model, device="cpu")
    gens = [torch.Generator().manual_seed(v) for v in range(2)]

    def run(fn):
        with monkeypatch.context() as mp:
            mp.setattr(tlayers, "draw_uniform", masks_as_uniforms(masks))
            port_draws(name, draws, mp)
            return fn()

    with torch.no_grad():
        probs = run(lambda: task.predict_probs(model, torch.as_tensor(imgs), gens))
    t_e, t_a = (T_E, 1) if name == "mcdropout" else (1, T_A)
    assert tuple(probs.shape) == (2, 2, t_e, t_a, *shape)
    np.testing.assert_allclose(probs.numpy(), np.stack(probs_ref), rtol=0, atol=1e-4)

    singles = []
    for v in range(2):
        with monkeypatch.context() as mp:
            mp.setattr(tlayers, "draw_uniform", masks_as_uniforms(masks[v * len(masks) // 2:]))
            port_draws(name, draws[v:v + 1], mp)
            singles.append(tpred._to_numpy(predictor(imgs[v], gens[v])))
    both = tpred._to_numpy(run(lambda: predictor.batched(imgs, gens)))
    for v, ref in enumerate(refs):
        for got in (singles[v], tpred._tree_map(lambda a: a[v], both)):
            assert set(got) == set(ref)
            assert got["pred"].dtype == ref["pred"].dtype == np.int32
            assert got["pred_samples"].dtype == ref["pred_samples"].dtype == np.float32
            assert got["pred_samples"].shape == ref["pred_samples"].shape == (2, t_e, t_a, 64, 64)
            differ = got["pred"] != ref["pred"]
            assert differ.sum() <= 8
            if channels == 1 and differ.any():
                mean = ref["pred_samples"].mean(axis=(1, 2))
                assert np.abs(mean[differ] - 0.5).max() <= 1e-3
            same = (got["pred_samples"] > 0) == (ref["pred_samples"] > 0)
            assert same.mean() > 0.999
            np.testing.assert_allclose(got["pred_samples"][same], ref["pred_samples"][same],
                                       rtol=0, atol=1e-4)
            agree = same.all(axis=(1, 2))
            np.testing.assert_allclose(got["entropy_map"][agree], ref["entropy_map"][agree],
                                       rtol=0, atol=1e-4)
            np.testing.assert_array_equal(got["uncertainty_map"], got["entropy_map"])
            np.testing.assert_allclose(got["instant_uncertainty"]["entropy_mean"],
                                       ref["instant_uncertainty"]["entropy_mean"], rtol=1e-3)
            assert np.all(got["entropy_map"][:, :10] == 0) and np.all(got["entropy_map"][:, -10:] == 0)
            if channels == 1:
                assert 0 <= got["pred_samples"].min() and got["pred_samples"].max() <= 1


def _synthetic(size=64, n_patients=5):
    return synthetic_camus_data(n_patients=n_patients, size=size, seed=1)


@pytest.mark.parametrize("name", list(TASKS))
def test_run_predict_serves_the_baselines(name, tmp_path):
    """run_predict dispatches a segmentation baseline to SegPredictor before
    any shape prior is fit (no prior file is written), gives the JAX
    package's BatchResult fields, shapes and dtypes, and serves two views
    per dispatch (predict_batch_views=2) as it serves one."""
    _, tcls, kwargs, task_kwargs = TASKS[name]
    data = _synthetic()
    task = tcls(data_params=data.data_params, model_kwargs=dict(kwargs), **task_kwargs)
    model = task.build_model(device="cpu", generator=torch.Generator().manual_seed(0))
    prior = tmp_path / "psm.npz"
    cfg = {"seed": 3, "task": {"psm_path": str(prior)}}
    one = tpred.run_predict(task, model, data, cfg, device="cpu")
    two = tpred.run_predict(task, model, data, {**cfg, "predict_batch_views": 2}, device="cpu")
    assert not prior.exists()
    t_e, t_a = (T_E, 1) if name == "mcdropout" else (1, T_A)
    assert len(one) == len(two) == 2
    for a, b in zip(one, two):
        assert a.mu is None and a.contour_samples is None
        assert a.pred.shape == (2, 64, 64) and a.pred.dtype == np.int32
        assert a.pred_samples.shape == (2, t_e, t_a, 64, 64)
        assert a.pred_samples.dtype == a.entropy_map.dtype == np.float32
        assert set(a.instant_uncertainty) == {"entropy_mean"}
        assert np.isfinite(a.entropy_map).all() and a.gt.shape == (2, 64, 64)
        np.testing.assert_array_equal(a.pred, b.pred)
        np.testing.assert_allclose(a.pred_samples, b.pred_samples, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_seg_results():
    """BatchResults made by the JAX package's SegPredictor (SSN, binary) on
    the test views of a synthetic source with both views of 2 patients."""
    data = synthetic_camus_data(n_patients=10, size=64, seed=1)
    jtask, jmodel, variables, task, _ = make_pair(
        jseg.StochasticSegmentationNetwork, tseg.StochasticSegmentationNetwork, 1, SMALL,
        t_a=4, rank=2)
    jpred = jpredict.SegPredictor(jtask, jmodel)
    results = []
    for vi, view in enumerate(data.predict_views("test")):
        out = jax.tree.map(np.asarray, jpred(variables, jnp.asarray(view["img"]),
                                             jax.random.fold_in(jax.random.key(3), vi)))
        results.append(BatchResult(
            id=view["id"], labels=data.data_params.labels, img=view["img"], gt=view["gt"],
            pred=out["pred"], pred_samples=out["pred_samples"],
            uncertainty_map=out["uncertainty_map"], entropy_map=out["entropy_map"],
            instant_uncertainty=out["instant_uncertainty"], voxelspacing=view["voxelspacing"],
            instants=view["instants"], image_quality=view["image_quality"]))
    assert len(results) == 4
    return results


VOLUME_KEYS = ("EDV", "ESV", "EF", "Volume")


def _close_seg(got, ref, name, scale):
    """_close, except for the Simpson volumes of the masks and what derives
    from them: within 1e-2 relative plus 1e-3 of the column's scale."""
    if isinstance(ref, (bool, str)) or ref is None or not any(k in name for k in VOLUME_KEYS):
        _close(got, ref, name)
        return
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-3 * scale, err_msg=name)


def test_processors_on_segmentation_results_match_jax(jax_seg_results, tmp_path):
    """instant_metrics, calibration, mutual_info and clinical_metrics (its
    mask-space GLS branch) on the same JAX-made segmentation results: no
    processor error, the same summary keys, CSV rows and columns, and the
    same values, as _close holds them (tests/test_torch_port_results.py),
    except the Simpson volumes of the masks and what derives from them
    (EDV, ESV, EF, Volume). Their disk diameters sample each chord at 256
    nearest pixels, and on the ragged masks of an untrained model a sample
    can sit within rounding of a pixel edge, where XLA's fused
    multiply-adds and torch's separate rounding pick different pixels: each
    diameter is held within one chord step of JAX's (on these masks one of
    160 diameters differs, by one step, 0.188 mm), and those values within
    1e-2 relative plus 1e-3 of their column's scale."""
    import pandas as pd

    from contouring_uncertainty_tpu.utils import clinical as jclinical
    from contouring_uncertainty_torch.utils import clinical as tclinical

    moved = 0
    for res in jax_seg_results:
        masks = (res.pred != 0).astype(np.float32)
        spacing = np.asarray(res.voxelspacing[-2:], np.float32)
        d_t, _ = tclinical.lv_disk_diameters(torch.as_tensor(masks), spacing)
        d_j = np.stack([np.asarray(jclinical.lv_disk_diameters(jnp.asarray(m),
                                                                jnp.asarray(spacing))[0])
                        for m in masks])
        max_half = 0.5 * np.hypot(64 * spacing[0], 64 * spacing[1])
        step = 2 * max_half / 255
        diff = np.abs(d_t.numpy() - d_j)
        assert diff.max() <= step * 1.001
        moved += int((diff > 1e-3).sum())
    assert moved <= 2

    cfg = {"data": {"results_processors": PROCESSORS}}
    got = run_processors(jax_seg_results, tmp_path / "port", cfg, device="cpu")
    ref = run_jax_processors(jax_seg_results, tmp_path / "jax", cfg)
    assert "processor_errors" not in got and "processor_errors" not in ref
    ref = {k: v for k, v in ref.items() if not k.endswith("figures_error")}
    assert set(got) == set(ref)
    for prefix in PROCESSORS:
        assert any(k.startswith(prefix + "/") for k in got), prefix
    for key, value in ref.items():
        _close_seg(got[key], value, key, abs(value) if isinstance(value, float) else 0.0)
    for name in ("instant_metrics.csv", "clinical/instant_df.csv", "clinical/view_df.csv",
                 "clinical/patient_df.csv", "clinical/volume_df.csv"):
        a = pd.read_csv(tmp_path / "port" / name, index_col=0)
        b = pd.read_csv(tmp_path / "jax" / name, index_col=0)
        assert list(a.index) == list(b.index) and list(a.columns) == list(b.columns), name
        assert list(a.dtypes) == list(b.dtypes) and len(b) > 0
        for col in b.columns:
            if b[col].dtype.kind in "fi":
                ok = ~np.isnan(b[col].to_numpy(float))
                assert np.array_equal(ok, ~np.isnan(a[col].to_numpy(float))), (name, col)
                ref_col = b[col].to_numpy(float)[ok]
                _close_seg(a[col].to_numpy(float)[ok], ref_col, col,
                           float(np.abs(ref_col).max()) if ok.any() else 0.0)
            else:
                assert a[col].tolist() == b[col].tolist(), (name, col)
        if not any(k in c for c in b.columns for k in (*VOLUME_KEYS, "GLS")):
            assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


@pytest.fixture(scope="module")
def epistemic_pair():
    dp = dict(in_shape=(1, 64, 64), out_shape=(21, 2))
    jtask = JEpistemic(data_params=JDataParams(**dp), t_e=3, t_a=4, model_kwargs=dict(SMALL))
    task = EpistemicUncertainty(data_params=DataParams(**dp), t_e=3, t_a=4,
                                model_kwargs=dict(SMALL))
    jmodel = jtask.build_model()
    model = task.build_model(device="cpu", generator=torch.Generator().manual_seed(2))
    assert jtask.model_kwargs["drop_block"] is True and model.drop_block is True
    from test_torch_port_skew_model import torch_to_flax_params

    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((2, 1, 64, 64)))
    variables = {"params": jax.tree.map(jnp.asarray,
                                        torch_to_flax_params(model.state_dict(), shapes))}
    return jtask, jmodel, variables, task, model


def test_epistemic_task_matches_jax(epistemic_pair, imgs, monkeypatch):
    """predict (mu within 1e-3 px of JAX's, covariances exactly 0) and
    predict_point_stats (the T_e spread) with JAX's dropout masks; the
    AleatoricPredictor's fused mu and cov against JAX's fusion of the same
    forwards, cov within 1e-5 of the f64 spread of the means; its sampled
    outputs finite with the JAX package's shapes."""
    jtask, jmodel, variables, task, model = epistemic_pair
    key = jax.random.key(4)
    img = imgs[0]
    ((mu_j, cov_j), (pmu_j, pcov_j)), masks = capture_masks(
        lambda v, x, k: (jtask.predict(jmodel, v, x, rng=k),
                         jtask.predict_point_stats(jmodel, v, x, rng=k)))(
        variables, jnp.asarray(img), key)
    half = len(masks) // 2  # predict_point_stats repeats predict's forward, key and masks
    assert half > 0 and all((a == b).all() for a, b in zip(masks[:half], masks[half:]))
    masks = masks[:half]

    def with_masks(fn):
        with monkeypatch.context() as mp:
            mp.setattr(tlayers, "draw_uniform", masks_as_uniforms(masks))
            return fn()

    with torch.no_grad():
        mu, cov = with_masks(lambda: task.predict(model, torch.as_tensor(img), None))
        pmu, pcov = with_masks(lambda: task.predict_point_stats(model, torch.as_tensor(img)))
    assert mu.shape == (2, 3, 21, 2) and cov.shape == (2, 3, 21, 2, 2)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=0, atol=1e-3)
    assert not cov.any() and not np.asarray(cov_j).any()
    assert float((mu[:, 0] - mu[:, 1]).abs().max()) > 1e-3  # dropout is live
    np.testing.assert_allclose(pmu.numpy(), np.asarray(pmu_j), rtol=0, atol=1e-3)
    np.testing.assert_allclose(pcov.numpy(), np.asarray(pcov_j), rtol=0,
                               atol=1e-3 * float(np.abs(np.asarray(pcov_j)).max()))

    prior = fit_shape_prior(synthetic_camus_data(n_patients=5, size=64, seed=1)
                            .train_arrays("train")["contour"])
    predictor = tpred.AleatoricPredictor(task, model, PosteriorShapeModelSampler(prior,
                                                                                 device="cpu"),
                                         device="cpu")
    out = tpred._to_numpy(with_masks(lambda: predictor(img, torch.Generator().manual_seed(0))))
    jmu, jcov = jpredict.fuse_epistemic_aleatoric(mu_j, cov_j)
    np.testing.assert_allclose(out["mu"], np.asarray(jmu), rtol=0, atol=1e-3)
    d = np.asarray(mu_j, np.float64) - np.asarray(mu_j, np.float64).mean(1, keepdims=True)
    spread = (d[..., :, None] * d[..., None, :]).mean(1)
    np.testing.assert_allclose(out["cov"], spread, rtol=1e-3,
                               atol=1e-3 * np.abs(spread).max())
    np.testing.assert_allclose(out["cov"], np.asarray(jcov), rtol=1e-3,
                               atol=1e-3 * np.abs(spread).max())
    # The predictor's own draws: its fused covariance is the spread of its
    # forwards' means (the same generator gives the same masks).
    with torch.no_grad():
        mu_own, _ = task.predict(model, torch.as_tensor(img), torch.Generator().manual_seed(0))
    res = tpred._to_numpy(predictor(img, torch.Generator().manual_seed(0)))
    d = mu_own.double() - mu_own.double().mean(1, keepdim=True)
    spread = (d[..., :, None] * d[..., None, :]).mean(1).numpy()
    np.testing.assert_allclose(res["cov"], spread, rtol=1e-5, atol=1e-5 * np.abs(spread).max())
    shapes = {"contour_samples": (2, 3, 4, 21, 2), "pred_samples": (2, 3, 4, 64, 64),
              "post_cov": (2, 21, 2, 2), "uncertainty_map": (2, 64, 64)}
    for k, s in shapes.items():
        assert res[k].shape == s and np.isfinite(res[k].astype(np.float64)).all(), k


RUNNER = ["data=synthetic", "data.image_size=32", "data.n_patients=5",
          "task.model.kernels=[[3,3],[3,3],[3,3]]", "task.model.strides=[[1,1],[2,2],[2,2]]",
          "task.optim.name=adamw", "task.t_a=2", "task.t_e=2", "trainer.batch_size=4",
          "trainer.max_epochs=1", "seed=4",
          "data.results_processors=[instant_metrics, calibration, mutual_info, clinical_metrics]"]


@pytest.mark.parametrize("name", ["mcdropout", "aleatoric", "tta", "ssn", "epistemic"])
def test_runner_trains_tests_and_predicts_each_task(name, tmp_path):
    """runner.run(device="cpu") on a small synthetic configuration trains
    the task one epoch, computes its test metrics, predicts every test view
    and runs the processors without an error."""
    result = runner.run(RUNNER + [f"task={name}", f"save_path={tmp_path}",
                                  f"task.psm_path={tmp_path / 'psm.npz'}"], device="cpu")
    assert len(result["history"]) == 1 and "processor_errors" not in result
    test = result["test_metrics"]
    expected = ({"test/loss", "test/distance_loss", "test/loss_term1", "test/loss_term2",
                 "test/dice"} if name == "epistemic" else {"test/loss", "test/ce", "test/dice"})
    assert set(test) == expected and all(np.isfinite(v) for v in test.values())
    views = result["predict"]
    assert len(views) == 2
    t_e = {"mcdropout": 2, "epistemic": 2}.get(name, 1)
    t_a = 1 if name == "mcdropout" else 2
    for view in views:
        assert view.pred_samples.shape == (2, t_e, t_a, 32, 32)
        assert np.isfinite(view.entropy_map).all()
    assert (tmp_path / "psm.npz").exists() == (name == "epistemic")
    assert (tmp_path / "results" / "metrics.json").exists()
