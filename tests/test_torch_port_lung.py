"""PyTorch port vs JAX package: the JSRT chest X-ray path (data/lung.py,
factory.build_data for `lung` and `lung-cont`, multi-structure contour
groups in predict.py `AleatoricPredictor`, the lung functions of
utils/clinical.py and results/lung_clinical.py), and `runner.run` on JSRT.

Films are 64^2, written by the JAX package's `write_jsrt_hdf5`; models are
4-stage UNets with the port's seeded weights put on the flax tree. The
JAX fills take its exact top-k path (its plain reference).

Tolerances: the reader, the generator's contours, gt and images, the
contour-to-mask rasterization, the lung clinical functions and the label
map painted from the same polygons are bitwise. From the same landmarks
each package splines its own polygons, which differ by ~1e-4 px, so at
most 1e-4 of the sample label-map pixels and 4 `pred` pixels per frame
may differ; the Gaussian grouped umap differs by more than 1e-5 on at most
0.1% of its pixels, the skew one on at most 0.5% (tests/test_torch_port_
predict.py and test_torch_port_skew_predict.py give why); the skew mode is
within one profile step of JAX's; fused moments and scalars within 1e-5
relative. The whole predictor (real forward, other RNG streams): mu within
1e-4 px, cov within 1e-3 of its scale, the sampled outputs in
distribution. lung_clinical's CSV: the mask metrics equal, the contour
areas within 1e-5 + 5e-5 * |value| (f32 spline sums).
"""

import csv
from functools import partial
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu import factory as jfactory
from contouring_uncertainty_tpu import predict as jpred
from contouring_uncertainty_tpu.config import compose as jcompose
from contouring_uncertainty_tpu.data import lung as jl
from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
from contouring_uncertainty_tpu.ops import rasterize as jr
from contouring_uncertainty_tpu.sampler import PosteriorShapeModelSampler as JSampler
from contouring_uncertainty_tpu.sampler import fit_shape_prior as j_fit
from contouring_uncertainty_tpu.tasks import DSNTAleatoric as JTask
from contouring_uncertainty_tpu.utils import clinical as jC
from contouring_uncertainty_torch import factory, runner
from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch.config import compose
from contouring_uncertainty_torch.data import lung as tl
from contouring_uncertainty_torch.data.config import BatchResult, LungLabel
from contouring_uncertainty_torch.ops import spline as ts
from contouring_uncertainty_torch.results import run_processors
from contouring_uncertainty_torch.sampler import PosteriorShapeModelSampler, fit_shape_prior
from contouring_uncertainty_torch.tasks import DSNTAleatoric
from contouring_uncertainty_torch.utils import clinical as C
from test_torch_port_results import run_jax_processors
from test_torch_port_skew_model import torch_to_flax_params

torch.set_num_threads(1)

SIZE = 64
SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3)
GROUPS = tuple((a, b, label) for _, a, b, label in tl.STRUCTURES)
SPLITS = ("train", "val", "test")


@pytest.fixture(scope="module")
def jsrt_file(tmp_path_factory):
    """10 films (6 train, 2 val, 2 test) written by the JAX package."""
    return jl.write_jsrt_hdf5(tmp_path_factory.mktemp("jsrt") / "jsrt.h5", n_items=10,
                              size=SIZE, seed=3)


def _assert_same_arrays(got, ref):
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_reader_and_factory_match_jax(jsrt_file, tmp_path, monkeypatch):
    """JSRTContourData on the JAX package's file: train_arrays, predict_views,
    data_params and contour_groups equal to JAX's, and `from_arrays` on
    `make_jsrt_arrays` equal to reading the file; images stored in 0-255
    are divided by 255 in both; build_data of `lung-cont` with a transform
    gives JAX's images (1e-6) and LungLabel; an empty dataset_path fails
    in both, with no generated stand-in."""
    port, ref = tl.JSRTContourData(jsrt_file), jl.JSRTContourData(jsrt_file)
    mem = tl.JSRTContourData.from_arrays(tl.make_jsrt_arrays(10, SIZE, 3))
    for split in SPLITS:
        _assert_same_arrays(port.train_arrays(split), ref.train_arrays(split))
        _assert_same_arrays(mem.train_arrays(split), ref.train_arrays(split))
        for view, jview in zip(port.predict_views(split), ref.predict_views(split), strict=True):
            assert view.keys() == jview.keys() and view["instants"] == jview["instants"]
            for key in ("id", "img", "gt", "contour", "voxelspacing"):
                np.testing.assert_array_equal(view[key], jview[key], err_msg=key)
    dp, jdp = port.data_params, ref.data_params
    assert (dp.in_shape, dp.out_shape) == (jdp.in_shape, jdp.out_shape) == ((1, SIZE, SIZE),
                                                                          (120, 2))
    assert [int(label) for label in dp.labels] == [int(label) for label in jdp.labels]
    assert port.contour_groups == ref.contour_groups == GROUPS

    scaled = tmp_path / "scaled.h5"
    with h5py.File(jsrt_file, "r") as src, h5py.File(scaled, "w") as dst:
        for item in src["train"]:
            g = dst.create_group(f"train/{item}")
            g.create_dataset("img", data=np.asarray(src[f"train/{item}/img"]) * 255.0)
            for key in ("gt", "contour"):
                g.create_dataset(key, data=np.asarray(src[f"train/{item}/{key}"]))
    _assert_same_arrays(tl.JSRTContourData(scaled).train_arrays("train"),
                        jl.JSRTContourData(scaled).train_arrays("train"))

    overrides = ["data=lung-cont", f"data.dataset_path={jsrt_file}",
                 "data/transform=normalizesample"]
    data, jdata = factory.build_data(compose(overrides)), jfactory.build_data(jcompose(overrides))
    assert isinstance(data, tl.JSRTContourData)
    assert data.labels == (LungLabel.BG, LungLabel.LUNG, LungLabel.HEART)
    np.testing.assert_allclose(data.train_arrays("train")["img"],
                               jdata.train_arrays("train")["img"], rtol=0, atol=1e-6)
    assert abs(data.train_arrays("train")["img"].mean()) < 1e-4
    monkeypatch.delenv("LUNG_DATA_PATH", raising=False)
    for build, comp in ((factory.build_data, compose), (jfactory.build_data, jcompose)):
        cfg = comp(["data=lung"])
        assert cfg["data"]["dataset_path"] == ""
        with pytest.raises(OSError):
            build(cfg).data_params


def test_generator_matches_jax_file(jsrt_file, tmp_path):
    """make_jsrt_arrays draws the JAX generator's films for the same seed:
    ids, contours, gt and images equal to the file JAX writes, and the
    port's write_jsrt_hdf5 writes the same file contents."""
    arrays = tl.make_jsrt_arrays(10, SIZE, 3)
    port_file = tl.write_jsrt_hdf5(tmp_path / "port.h5", n_items=10, size=SIZE, seed=3)
    with h5py.File(jsrt_file, "r") as ref, h5py.File(port_file, "r") as got:
        assert sorted(ref) == sorted(got) == sorted(SPLITS)
        for split in SPLITS:
            ids = list(ref[split])
            assert ids == list(got[split]) == list(arrays[split]["id"])
            for i, item in enumerate(ids):
                for key in ("img", "gt", "contour"):
                    want = np.asarray(ref[f"{split}/{item}/{key}"])
                    for value in (arrays[split][key][i], np.asarray(got[f"{split}/{item}/{key}"])):
                        assert value.dtype == want.dtype, key
                        np.testing.assert_array_equal(value, want, err_msg=f"{item}/{key}")


def _hand_made_overlap():
    """Integer-vertex ellipses at 64^2 whose heart overlaps both lungs."""
    def ellipse(n, cx, cy, rx, ry):
        t = np.linspace(0, 2 * np.pi, n, endpoint=False)
        return np.round(np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], -1))

    return np.concatenate([ellipse(44, 20, 30, 10, 20), ellipse(50, 44, 30, 10, 20),
                           ellipse(26, 32, 40, 12, 10)]).astype(np.float32)


def test_lung_contour_to_mask_matches_jax():
    """The port's f64 even-odd test equals matplotlib's contains_points
    (through the JAX function) on every pixel of 24 generated 256^2 films,
    and on a hand-made overlap whose vertices lie on the pixel grid, where
    the lungs win over the heart."""
    arrays = tl.make_jsrt_arrays(24, 256, seed=11)
    contours = np.concatenate([arrays[s]["contour"] for s in SPLITS])
    assert len(contours) == 24
    for contour in contours:
        np.testing.assert_array_equal(tl.lung_contour_to_mask(contour, (256, 256)),
                                      jl.lung_contour_to_mask(contour, (256, 256)))
    contour = _hand_made_overlap()
    got = tl.lung_contour_to_mask(contour, (SIZE, SIZE))
    np.testing.assert_array_equal(got, jl.lung_contour_to_mask(contour, (SIZE, SIZE)))
    heart = tl.lung_contour_to_mask(np.concatenate([contour[:94] * 0 - 5, contour[94:]]),
                                    (SIZE, SIZE)) == 2
    assert heart.sum() > 0 and (got[heart] == 1).sum() > 20 and (got[heart] == 2).sum() > 20


def test_lung_clinical_functions_match_jax():
    """mask_width, cardiothoracic_ratio and lung_mask_metrics equal to JAX's
    (NaN where JAX has NaN) on generated gt maps, the same with pixels
    relabelled at random, random label maps, an empty map (CTR NaN), lungs
    alone and heart alone; batched over two leading axes."""
    rng = np.random.default_rng(0)
    gts = np.concatenate([tl.make_jsrt_arrays(5, SIZE, 1)[s]["gt"] for s in SPLITS])
    noisy = np.where(rng.uniform(size=gts.shape) < 0.05, rng.integers(0, 3, gts.shape), gts)
    random = rng.choice(3, size=(3, SIZE, SIZE), p=[0.9, 0.07, 0.03])
    empty = np.zeros((1, SIZE, SIZE), np.int64)
    segs = np.concatenate([gts, noisy, random, empty, np.where(gts == 2, 0, gts)[:1],
                           np.where(gts == 1, 0, gts)[:1]]).astype(np.int32)
    n = len(segs)
    jsegs = jnp.asarray(segs)
    ref = {"width": jax.vmap(jC.mask_width)(jsegs == 2),
           "ctr": jax.vmap(jC.cardiothoracic_ratio)(jsegs),
           "metrics": jax.vmap(jC.lung_mask_metrics)(jsegs)}
    tsegs = torch.as_tensor(segs).reshape(2, n // 2, SIZE, SIZE)
    got = {"width": C.mask_width(tsegs == 2), "ctr": C.cardiothoracic_ratio(tsegs),
           "metrics": C.lung_mask_metrics(tsegs)}
    for key, value in got.items():
        assert value.dtype == torch.float32, key
        np.testing.assert_array_equal(value.reshape(n, -1).numpy(),
                                      np.asarray(ref[key]).reshape(n, -1), err_msg=key)
    ctr = got["ctr"].reshape(n).numpy()
    assert np.isnan(ctr[2 * len(gts) + 3]) and np.isfinite(np.delete(ctr, 2 * len(gts) + 3)).all()
    assert ctr[-1] == 1.0 and ctr[-2] == 0.0
    assert ((0.2 < ctr[:len(gts)]) & (ctr[:len(gts)] < 0.8)).all()


def _sample_landmarks(n, seed, scale=0.7):
    """(n, 120, 2) f32 JSRT landmarks at 64^2 with Gaussian jitter."""
    arrays = tl.make_jsrt_arrays(max(n, 5), SIZE, seed)
    contours = np.concatenate([arrays[s]["contour"] for s in SPLITS])[:n]
    jitter = np.random.default_rng(seed).normal(scale=scale, size=contours.shape)
    return (contours + jitter).astype(np.float32)


def test_rasterize_labelmap_matches_jax(monkeypatch):
    """The label map of the same sample polygons (the port's splines of
    each structure, filled by the JAX exact path for JAX's painting) is
    bitwise JAX's, with the lungs painted over the heart where they
    overlap. (From the landmarks alone, each package with its own splines,
    test_grouped_gaussian_outputs_match_jax_on_the_same_samples holds the
    label maps to 1e-4 of their pixels.)"""
    points = _sample_landmarks(6, seed=5).reshape(2, 3, 120, 2)
    fill = jax.jit(jax.vmap(lambda d: jr.polygon_fill(d, SIZE, SIZE, exact_topk=True)))

    def fill_port_splines(pts, h, w):
        dense = ts.contour_spline(torch.as_tensor(np.array(pts)), n=1024, close=False).numpy()
        return fill(jnp.asarray(dense.reshape(-1, 1024, 2))).reshape(*pts.shape[:-2], h, w)

    monkeypatch.setattr(jpred, "rasterize_batch", fill_port_splines)
    ref = np.asarray(jpred.AleatoricPredictor._rasterize_labelmap(
        SimpleNamespace(groups=GROUPS), jnp.asarray(points), SIZE, SIZE))
    got = tpred.rasterize_labelmap(torch.as_tensor(points), GROUPS, SIZE, SIZE)
    assert got.shape == (2, 3, SIZE, SIZE) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    heart = np.asarray(fill_port_splines(points[..., 94:, :], SIZE, SIZE)) > 0
    assert (ref[heart] == 1).sum() > 0 and set(np.unique(ref)) == {0.0, 1.0, 2.0}


class _JFixed:
    """A JAX task and sampler handing out fixed predictions and samples."""

    def __init__(self, outs, samples, t_a):
        self.outs, self.samples, self.t_a = outs, samples, t_a
        self.data_params = JDataParams(in_shape=(1, SIZE, SIZE), out_shape=(120, 2))

    def predict(self, model, variables, img, rng=None, mesh=None):
        return tuple(jnp.asarray(a) for a in self.outs)

    def sample_batch(self, key, mu, cov, alpha=None, n=None):
        return jnp.asarray(self.samples)


class _TFixed(_JFixed):
    """The port's counterpart: one view (V = 1) of the same arrays."""

    def predict(self, model, imgs, generator=None, shard=None):
        return tuple(torch.as_tensor(a)[None] for a in self.outs)

    def sample_batch(self, generators, mu, cov, n=None, alpha=None):
        return torch.as_tensor(self.samples)[None]


def _fixed_inputs():
    """One film's (T_e = 2) predictions around JSRT landmarks with random
    SPD covariances (0.3-3 px^2) and alphas; 4 samples per forward."""
    rng = np.random.default_rng(9)
    mu_te = _sample_landmarks(2, seed=2, scale=0.3).reshape(1, 2, 120, 2)
    a = rng.normal(size=(1, 2, 120, 2, 2)) * 0.8
    cov_te = (a @ a.transpose(0, 1, 2, 4, 3) + 0.3 * np.eye(2)).astype(np.float32)
    alpha_te = rng.normal(scale=2.0, size=(1, 2, 120, 2)).astype(np.float32)
    samples = (mu_te[:, :, None] + rng.normal(size=(1, 2, 4, 120, 2))).astype(np.float32)
    return (mu_te, cov_te, alpha_te), samples


def _assert_label_maps_close(got, ref):
    """Sample label maps (uint8 {0, 1, 2}) within 1e-4 of their pixels and
    `pred` within 4 pixels per frame of JAX's, from the same landmarks."""
    assert got["pred_samples"].dtype == ref["pred_samples"].dtype == np.uint8
    assert set(np.unique(got["pred_samples"])) == {0, 1, 2}
    assert (got["pred_samples"] != ref["pred_samples"]).mean() <= 1e-4
    assert got["pred"].dtype == np.int32 and set(np.unique(got["pred"])) <= {0, 1, 2}
    assert ((got["pred"] != ref["pred"]).sum(axis=(-2, -1)) <= 4).all()
    assert ((ref["pred"] == 2).sum(axis=(-2, -1)) > 20).all()


def _assert_scalars_close(got, ref, rtol):
    for group in ("point_uncertainty", "instant_uncertainty"):
        assert got[group].keys() == ref[group].keys()
        for key, value in ref[group].items():
            tol = 1e-3 if key in ("umap_mean", "entropy_mean") else rtol
            np.testing.assert_allclose(got[group][key], value, rtol=tol, err_msg=key)


def test_grouped_skew_outputs_match_jax():
    """Both AleatoricPredictors after the forward, on the same skew
    predictions and samples of one JSRT film: the fused moments and alpha
    within 1e-5, the sample label maps and `pred` (the label map of the
    mode) as `_assert_label_maps_close`, the mode within 0.02 px (one
    profile step is 6 u / 1000, u >= 0.5 px here), the grouped skew umap
    (each structure's map over its maximum, the sum clipped to [0, 1])
    beyond 1e-5 on at most 0.5% of its pixels, and the scalars within 1e-5
    (the means over the predicted area 1e-3)."""
    outs, samples = _fixed_inputs()
    jp = jpred.AleatoricPredictor(_JFixed(outs, samples, 4), None, _JFixed(outs, samples, 4),
                                  contour_groups=GROUPS)
    ref = jax.tree.map(np.asarray, jax.jit(jp._view_fn)(
        None, jnp.zeros((1, 1, SIZE, SIZE)), jax.random.key(0)))
    fixed = _TFixed(outs, samples, 4)
    tp = tpred.AleatoricPredictor(fixed, torch.nn.Identity(), fixed, contour_groups=GROUPS,
                                  device="cpu")
    got = tpred._to_numpy(tp(np.zeros((1, 1, SIZE, SIZE), np.float32)))
    assert got.keys() == ref.keys()
    for key in ("mu", "cov", "alpha", "post_mu", "post_cov"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-5, err_msg=key)
    _assert_label_maps_close(got, ref)
    assert np.abs(got["mode"] - ref["mode"]).max() < 0.02
    umap_t, umap_j = got["uncertainty_map"], ref["uncertainty_map"]
    assert umap_t.min() >= 0.0 and umap_t.max() <= 1.0 and (umap_j > 0).mean() > 0.1
    assert (np.abs(umap_t - umap_j) > 1e-5).mean() <= 5e-3
    _assert_scalars_close(got, ref, 1e-5)


def test_point_instant_uncertainty_groups_match_jax():
    """point_instant_uncertainty with the JSRT groups (cov_projection
    summed over the structures) against JAX on the same inputs: within
    1e-5 relative."""
    (mu_te, cov_te, _), _ = _fixed_inputs()
    rng = np.random.default_rng(2)
    umap = rng.uniform(size=(1, SIZE, SIZE)).astype(np.float32)
    pred = rng.integers(0, 3, size=(1, SIZE, SIZE)).astype(np.int32)
    args = (mu_te[:, 0], cov_te[:, 0], cov_te[:, 1], umap, umap * 0.5, pred)
    mine = tpred.point_instant_uncertainty(*(torch.as_tensor(a) for a in args), groups=GROUPS)
    theirs = jax.jit(partial(jpred.point_instant_uncertainty, groups=GROUPS))(
        *(jnp.asarray(a) for a in args))
    for g, r in zip(mine, theirs):
        assert g.keys() == r.keys()
        for key in r:
            np.testing.assert_allclose(g[key].numpy(), np.asarray(r[key]), rtol=1e-5,
                                       err_msg=key)


def test_single_structure_options_raise_on_jsrt(jsrt_file, tmp_path):
    """soft_mask with several structures raises ValueError (JAX asserts),
    and the sequence sampler finds no (ED, ES) pair in JSRT's one-frame
    views, as in JAX."""
    data = tl.JSRTContourData(jsrt_file)
    task = DSNTAleatoric(data_params=data.data_params, t_a=2, model_kwargs=SMALL)
    model = task.build_model(device="cpu")
    with pytest.raises(ValueError, match="soft_mask requires a single structure"):
        tpred.AleatoricPredictor(task, model, None, soft_mask=True,
                                 contour_groups=data.contour_groups, device="cpu")
    cfg = {"task": {"psm_path": str(tmp_path / "p.npz"), "sequence_sampler": True}}
    with pytest.raises(ValueError, match="distinct ED and ES"):
        tpred.run_predict(task, model, data, cfg, device="cpu")


T_A = 64


@pytest.fixture(scope="module")
def whole_predictor(jsrt_file):
    """The two test films through JAX's AleatoricPredictor (one view at a
    time) and the port's at V = 2 and one view at a time, with the same
    weights and priors, and the port's at V = 2 once more on JAX's
    samples; the same fixed logit map (sharp 1.5 px blobs at the first
    test film's landmarks) is added to both UNets' heatmaps."""
    data = tl.JSRTContourData(jsrt_file)
    views = list(data.predict_views("test"))
    imgs = np.stack([v["img"] for v in views])  # (2, 1, 1, 64, 64)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    target = views[0]["contour"]  # (1, 120, 2)
    bias = (-((xx - target[..., 0, None, None]) ** 2 + (yy - target[..., 1, None, None]) ** 2)
            / (2 * 1.5 ** 2)).astype(np.float32)  # (1, 120, 64, 64)
    train = data.train_arrays("train")["contour"]
    task = DSNTAleatoric(data_params=data.data_params, t_e=1, t_a=T_A, model_kwargs=SMALL)
    unet = task.build_model(device="cpu", generator=torch.Generator().manual_seed(4))
    jtask = JTask(data_params=JDataParams(in_shape=(1, SIZE, SIZE), out_shape=(120, 2)),
                  t_e=1, t_a=T_A, model_kwargs=SMALL)
    junet = jtask.build_model()
    shapes = jax.eval_shape(junet.init, jax.random.key(0), jnp.zeros((1, 1, SIZE, SIZE)))
    variables = {"params": jax.tree.map(jnp.asarray,
                                        torch_to_flax_params(unet.state_dict(), shapes))}

    class JBiased:
        def apply(self, v, x, **kw):
            return {"out": junet.apply(v, x, **kw)["out"] + jnp.asarray(bias)}

    class TBiased(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.unet = unet

        def forward(self, x, **kw):
            return {"out": self.unet(x, **kw)["out"] + torch.as_tensor(bias)}

    jp = jpred.AleatoricPredictor(jtask, JBiased(), JSampler(j_fit(train)),
                                  contour_groups=GROUPS)
    # JAX serves each view through `__call__` (one compile for both; its
    # `batched` path equals that to f32 tolerance, tests/test_parallel.py).
    ref = jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]), *(
        jp(variables, jnp.asarray(img), jax.random.key(i)) for i, img in enumerate(imgs)))
    tp = tpred.AleatoricPredictor(task, TBiased(), PosteriorShapeModelSampler(
        fit_shape_prior(train), device="cpu"), contour_groups=GROUPS, device="cpu")
    two = tpred._to_numpy(tp.batched(imgs, [tpred.view_generator(0, i) for i in range(2)]))
    ones = [tpred._to_numpy(tp(imgs[i], tpred.view_generator(0, i))) for i in range(2)]
    tp.sampler = SimpleNamespace(sample_batch=lambda *args, **kwargs: torch.as_tensor(
        ref["contour_samples"]))
    same = tpred._to_numpy(tp.batched(imgs, [None, None]))
    return ref, two, ones, same, views


def test_whole_predictor_deterministic_outputs_match_jax(whole_predictor):
    """Outputs fixed by the forward, at V = 2 and one view at a time: keys,
    shapes and dtypes as JAX's, mu within 1e-4 px, cov within 1e-3 of its
    scale, the cov-derived scalars within 1e-3 relative, `pred` (the label
    map of mu) within 4 pixels per frame and the grouped umap within its
    budget; the one-view results equal the batched ones to 1e-5."""
    ref, two, ones, _, _ = whole_predictor
    for vi, one in enumerate(ones):
        for got in (one, {k: (None if v is None else jax.tree.map(lambda a: a[vi], v))
                          for k, v in two.items()}):
            want = jax.tree.map(lambda a: a[vi], ref)
            assert got.keys() == want.keys()
            for key, r in want.items():
                if isinstance(r, np.ndarray):
                    assert got[key].shape == r.shape and got[key].dtype == r.dtype, key
            np.testing.assert_allclose(got["mu"], want["mu"], atol=1e-4)
            assert np.abs(got["cov"] - want["cov"]).max() < 1e-3 * np.abs(want["cov"]).max()
            for key in ("cov_xx", "cov_yy", "cov_det", "cov_eigval_sum"):
                np.testing.assert_allclose(got["point_uncertainty"][key],
                                           want["point_uncertainty"][key], rtol=1e-3,
                                           err_msg=key)
            for key in ("cov_det_mean", "cov_eigenvalue_mean", "cov_projection"):
                np.testing.assert_allclose(got["instant_uncertainty"][key],
                                           want["instant_uncertainty"][key], rtol=1e-3,
                                           err_msg=key)
            assert (got["pred"] != want["pred"]).sum() <= 4
            assert set(np.unique(want["pred"])) == {0, 1, 2}
            umap_t, umap_j = got["uncertainty_map"], want["uncertainty_map"]
            assert umap_t.min() >= 0.0 and umap_t.max() <= 1.0
            assert (np.abs(umap_t - umap_j) > 1e-5).mean() <= 1e-3
        for key in ("mu", "cov", "uncertainty_map", "contour_samples"):
            np.testing.assert_allclose(one[key], two[key][vi], rtol=0, atol=1e-5, err_msg=key)


def test_whole_predictor_sampled_outputs_match_jax_in_distribution(whole_predictor):
    """The sample population (T_a = 64 per film, other RNG streams) at
    V = 2: post_mu within 5 joint standard errors per coordinate; the
    summed posterior variance within 30%; each label's per-pixel share of
    the sample label maps within 5 binomial standard errors; the summed
    entropy within 15%; label maps hold {0, 1, 2} as uint8."""
    ref, two, _, _, _ = whole_predictor
    var_j = np.einsum("vnkii->vnki", ref["post_cov"])
    var_t = np.einsum("vnkii->vnki", two["post_cov"])
    assert (np.abs(two["post_mu"] - ref["post_mu"]) < 5 * np.sqrt((var_j + var_t) / T_A)).all()
    ratio = var_t.sum(axis=(-1, -2)) / var_j.sum(axis=(-1, -2))
    assert (np.abs(ratio - 1.0) < 0.3).all(), ratio
    assert two["pred_samples"].dtype == np.uint8
    assert set(np.unique(two["pred_samples"])) == {0, 1, 2}
    for label in (1, 2):
        occ_j = (ref["pred_samples"] == label).mean(axis=(2, 3), dtype=np.float64)
        occ_t = (two["pred_samples"] == label).mean(axis=(2, 3), dtype=np.float64)
        p = (occ_j + occ_t) / 2
        se = np.sqrt(np.maximum(p * (1 - p), 1.0 / T_A) * 2 / T_A)
        assert (np.abs(occ_t - occ_j) <= 5 * se).all(), label
    ent = two["entropy_map"].sum(axis=(-2, -1)) / ref["entropy_map"].sum(axis=(-2, -1))
    assert (np.abs(ent - 1.0) < 0.15).all(), ent


def test_grouped_gaussian_outputs_match_jax_on_the_same_samples(whole_predictor):
    """The port's predictor fed JAX's own samples, after the same forward:
    the posterior stats within 1e-5, the sample label maps and `pred` (the
    label map of mu) as `_assert_label_maps_close`, the grouped umap (each
    structure's map over its maximum, the sum clipped to [0, 1]) beyond
    1e-5 on at most 0.1% of its pixels, the entropy map within 1e-4 where
    the label maps agree, and the scalars within 1e-3 (the forward's)."""
    ref, _, _, same, _ = whole_predictor
    for key in ("post_mu", "post_cov", "contour_samples"):
        np.testing.assert_allclose(same[key], ref[key], rtol=1e-5, atol=1e-5, err_msg=key)
    _assert_label_maps_close(same, ref)
    umap_t, umap_j = same["uncertainty_map"], ref["uncertainty_map"]
    assert umap_t.min() >= 0.0 and umap_t.max() <= 1.0 and (umap_j > 0).mean() > 0.1
    assert (np.abs(umap_t - umap_j) > 1e-5).mean() <= 1e-3
    agree = (same["pred_samples"] == ref["pred_samples"]).all(axis=(2, 3))
    np.testing.assert_allclose(same["entropy_map"][agree], ref["entropy_map"][agree], atol=1e-4)
    _assert_scalars_close(same, ref, 1e-3)


def _view_df(path):
    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f))
    return header, rows


def _assert_view_df_close(got_dir, ref_dir):
    """lung_clinical/view_df.csv: the same columns and rows; the mask
    metrics' cells equal; a structure's contour area and its spread and
    error within 5e-5 of the structure's reference area (JAX's and the
    port's f32 shoelace sums over 1000 spline points differ by ~2e-6 of
    the area)."""
    header, rows = _view_df(got_dir / "lung_clinical" / "view_df.csv")
    ref_header, ref_rows = _view_df(ref_dir / "lung_clinical" / "view_df.csv")
    assert header == ref_header and [r[0] for r in rows] == [r[0] for r in ref_rows]
    for row, ref_row in zip(rows, ref_rows):
        for col, g, r in zip(header[1:], row[1:], ref_row[1:]):
            if g in ("True", "False", "") or not col.startswith("Area_"):
                assert g == r or float(g) == float(r), (row[0], col, g, r)
            else:
                area = float(ref_row[header.index("_".join(col.split("_")[:2]) + "_gt")])
                assert abs(float(g) - float(r)) <= 5e-5 * area, (row[0], col, g, r)
    return header, rows


def _seg_results(views):
    """Segmentation-style BatchResults: gt-derived predictions and 2 x 3
    sample label maps (f32) with random relabelling, no contour fields."""
    rng = np.random.default_rng(4)
    out = []
    for view in views:
        gt = view["gt"].astype(np.int32)
        samples = np.where(rng.uniform(size=(1, 2, 3) + gt.shape[1:]) < 0.03,
                           rng.integers(0, 3, (1, 2, 3) + gt.shape[1:]), gt[:, None, None])
        out.append(BatchResult(id=view["id"], img=view["img"], gt=view["gt"], pred=gt,
                               labels=(0, 1, 2), uncertainty_map=np.zeros(gt.shape, np.float32),
                               pred_samples=samples.astype(np.float32),
                               instants=view["instants"], voxelspacing=view["voxelspacing"]))
    return out


@pytest.mark.parametrize("kind", ["contour", "segmentation"])
def test_lung_clinical_matches_jax(kind, whole_predictor, tmp_path):
    """The lung_clinical processor on the same results (the JAX predictor's
    outputs for the contour task, with per-structure landmark areas; label
    maps for a segmentation task) in both packages: view_df.csv as stated
    in `_assert_view_df_close`, the same summary keys, the areas' errors
    within the same bar and the other values within 1e-5 + 5e-5 * |value|."""
    ref, _, _, _, views = whole_predictor
    if kind == "contour":
        results = [BatchResult(
            id=view["id"], img=view["img"], gt=view["gt"], contour=view["contour"],
            labels=(0, 1, 2), instants=view["instants"], voxelspacing=view["voxelspacing"],
            **{k: ref[k][vi] for k in ("pred", "mu", "mode", "cov", "post_mu", "post_cov",
                                       "contour_samples", "pred_samples", "uncertainty_map",
                                       "entropy_map")})
            for vi, view in enumerate(views)]
    else:
        results = _seg_results(views)
    cfg = {"data": {"results_processors": ["lung_clinical"]}}
    got = run_processors(results, tmp_path / "port", cfg, device="cpu")
    want = run_jax_processors(results, tmp_path / "jax", cfg)
    header, rows = _assert_view_df_close(tmp_path / "port", tmp_path / "jax")
    assert len(rows) == 2 and ("Area_heart_pred" in header) == (kind == "contour")
    assert "processor_errors" not in got and got.keys() == want.keys()
    for key, value in want.items():
        name = key.split("/", 1)[1]
        if name.startswith("Area_") and name.endswith("_error"):
            area = max(float(r[header.index(name.replace("_error", "_gt"))]) for r in rows)
            assert abs(got[key] - value) <= 5e-5 * area, key
        else:
            np.testing.assert_allclose(got[key], value, rtol=5e-5, atol=1e-5, err_msg=key)
    ctr = header.index("CTR_gt")
    assert all(0.0 < float(r[ctr]) < 1.0 for r in rows)


RUNS = {"dsnt-al": ("lung-cont", []),
        "dsnt-skew5": ("lung-cont", []),
        "mcdropout": ("lung", ["task.t_e=2"])}


@pytest.mark.parametrize("task", list(RUNS))
def test_runner_on_jsrt(task, jsrt_file, tmp_path):
    """runner.run(device="cpu") trains, tests and predicts on the JAX
    package's JSRT file with the data config's own processor list (skewness
    on Gaussian results included): no processor error, one lung_clinical
    row per test film, label maps in {0, 1, 2}."""
    data, extra = RUNS[task]
    result = runner.run([f"data={data}", f"data.dataset_path={jsrt_file}", f"task={task}",
                         "task.model.kernels=[[3,3],[3,3],[3,3],[3,3]]",
                         "task.model.strides=[[1,1],[2,2],[2,2],[2,2]]",
                         "task.model.drop_block=true", "task.t_a=3", "trainer.max_epochs=1",
                         "trainer.batch_size=4", f"save_path={tmp_path}",
                         f"task.psm_path={tmp_path / 'psm.npz'}", *extra], device="cpu")
    assert "processor_errors" not in result and "test_error" not in result
    assert np.isfinite(list(result["test_metrics"].values())).all()
    _, rows = _view_df(tmp_path / "results" / "lung_clinical" / "view_df.csv")
    assert len(rows) == len(result["predict"]) == 2
    for res in result["predict"]:
        assert set(np.unique(res.pred)) <= {0, 1, 2} and res.pred.shape == (1, SIZE, SIZE)
        assert set(np.unique(res.pred_samples)) <= {0, 1, 2}


@pytest.mark.parametrize("task", ["aleatoric", "tta", "ssn"])
def test_segmentation_baselines_serve_jsrt(task, jsrt_file, tmp_path):
    """The other baselines on `data=lung` (three classes, the SegPredictor
    multiclass branch): run_predict with lung's processor list, no
    processor error, label maps in {0, 1, 2}."""
    cfg = compose(["data=lung", f"data.dataset_path={jsrt_file}", f"task={task}",
                   "task.model.kernels=[[3,3],[3,3],[3,3],[3,3]]",
                   "task.model.strides=[[1,1],[2,2],[2,2],[2,2]]", "task.t_a=3",
                   f"save_path={tmp_path}"])
    data = factory.build_data(cfg)
    model_task = factory.build_task(cfg, data.data_params)
    assert model_task.n_channels == 3
    metrics = {}
    results = tpred.run_predict(model_task, model_task.build_model(device="cpu"), data, cfg,
                                device="cpu", metrics_out=metrics)
    assert "processor_errors" not in metrics and len(results) == 2
    for res in results:
        assert res.pred_samples.shape[:3] == (1, 1, 3)
        assert set(np.unique(res.pred_samples)) <= {0, 1, 2}
