"""PyTorch port vs JAX package: the skew serving path (utils/projection.py
with alpha, utils/umap.py `skew_umap`, sampler/psm_skew.py, the skew
branch of predict.py and the `skewness` processor of results/extras.py),
and the slice as a whole: `run_predict` with a DSNTSkew task at T_e=1
against the JAX package's `run_predict` on the same weights.

Deterministic outputs are compared with stated tolerances; the sampled
ones come from different RNG streams and are compared in distribution. To
give the untrained 4-stage UNet meaningful contours, both packages' models
add the same fixed logit map to its heatmaps: sharp 1.5 px blobs at the
view's own ground-truth landmarks, looked up by the image.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
from contouring_uncertainty_tpu.sampler import fit_shape_prior as j_fit
from contouring_uncertainty_tpu.sampler.psm_skew import SkewPosteriorShapeModelSampler as JSkewPSM
from contouring_uncertainty_tpu.tasks.dsnt_skew import DSNTSkew as JSkew
from contouring_uncertainty_tpu.utils import projection as jproj
from contouring_uncertainty_tpu.utils import umap as jumap
from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch.data.synthetic import (
    make_arrays,
    make_sample,
    synthetic_camus_data,
)
from contouring_uncertainty_torch.sampler import SkewPosteriorShapeModelSampler, fit_shape_prior
from contouring_uncertainty_torch.tasks import DSNTSkew
from contouring_uncertainty_torch.utils import projection as tproj
from contouring_uncertainty_torch.utils import umap as tumap

torch.set_num_threads(1)

SIZE = 64
SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3, drop_block=True)


def _mu_cov_alpha(seed, n=2):
    """Synthetic LV landmarks at 64^2, random SPD per-point covariances and
    skews of either sign."""
    mu = make_arrays(n, k=21, size=SIZE, seed=seed)[2]
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 21, 2, 2)) * 1.2
    cov = (a @ a.transpose(0, 1, 3, 2) + 0.5 * np.eye(2)).astype(np.float32)
    alpha = rng.normal(scale=2.0, size=(n, 21, 2)).astype(np.float32)
    return mu, cov, alpha


def test_projected_uncertainty_with_alpha_matches_jax():
    """projected_uncertainty(mu, cov, alpha) -> (u, v, alpha_proj): the
    rotated skew-normal marginal on each landmark's normal, within 1e-5
    relative (u, alpha_proj) and 1e-5 absolute (the unit directions v)."""
    mu, cov, alpha = _mu_cov_alpha(5, 4)
    ref = jax.jit(jax.vmap(jproj.projected_uncertainty))(
        *(jnp.asarray(a) for a in (mu, cov, alpha)))
    got = tproj.projected_uncertainty(*(torch.as_tensor(a) for a in (mu, cov, alpha)))
    assert len(got) == len(ref) == 3
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-5, atol=1e-5)


def _boundary_pixels(contours, shape):
    """Pixels within one pixel of any edge of the filled masks of
    `contours` (..., C, K, 2): where a crossing a few ulps away may flip."""
    from contouring_uncertainty_torch.ops.rasterize import rasterize_batch

    masks = rasterize_batch(torch.as_tensor(contours), *shape).numpy()
    edge = np.zeros(masks.shape, bool)
    edge[..., 1:, :] |= masks[..., 1:, :] != masks[..., :-1, :]
    edge[..., :-1, :] |= masks[..., 1:, :] != masks[..., :-1, :]
    edge[..., :, 1:] |= masks[..., :, 1:] != masks[..., :, :-1]
    edge[..., :, :-1] |= masks[..., :, 1:] != masks[..., :, :-1]
    return edge.any(-3)


def test_skew_umap_matches_jax():
    """skew_umap on the same (mu, cov, alpha), two frames in one call: the
    projected mode within one profile step (6 u / resolution) of JAX's;
    the entropy map within 1e-5 away from the level contours' boundary
    pixels, and at most 0.5% of all pixels beyond it (a level crossing is
    a first argmin of |pdf - level| on a grid, so a near tie can move one
    contour by a step; measured: none)."""
    mu, cov, alpha = _mu_cov_alpha(6)
    mode_j, ent_j = (np.asarray(a) for a in jax.vmap(
        lambda m, c, a: jumap.skew_umap(m, c, a, (SIZE, SIZE)))(
            *(jnp.asarray(a) for a in (mu, cov, alpha))))
    mode_t, ent_t = (a.numpy() for a in tumap.skew_umap(
        *(torch.as_tensor(a) for a in (mu, cov, alpha)), (SIZE, SIZE)))
    assert mode_t.shape == (2, 21, 2) and ent_t.shape == (2, SIZE, SIZE)
    u, _, _ = tproj.projected_uncertainty(*(torch.as_tensor(a) for a in (mu, cov, alpha)))
    step = 6.0 * u.numpy() / 1000
    assert (np.linalg.norm(mode_t - mode_j, axis=-1) <= step).all()
    assert (ent_j > 0).mean() > 0.05
    _, contours, _ = tumap.skew_level_contours(*(torch.as_tensor(a) for a in (mu, cov, alpha)))
    near = _boundary_pixels(contours.numpy(), (SIZE, SIZE))
    diff = np.abs(ent_t - ent_j) > 1e-5
    assert not (diff & ~near).any()
    assert diff.mean() <= 5e-3


def _prior_and_prediction():
    """A prior fit on 24 synthetic contours and one prediction at another
    synthetic contour: covariances of 0.5-4 px^2, skews of either sign."""
    contours = make_arrays(25, k=21, size=SIZE, seed=8)[2]
    mu = contours[:1]
    rng = np.random.default_rng(8)
    a = rng.normal(size=(1, 21, 2, 2)) * 0.8
    cov = (a @ a.transpose(0, 1, 3, 2) + 0.5 * np.eye(2)).astype(np.float32)
    alpha = rng.normal(scale=2.0, size=(1, 21, 2)).astype(np.float32)
    return contours[1:], mu, cov, alpha


def test_grid_skew_psm_sampler_matches_jax_in_distribution():
    """SkewPosteriorShapeModelSampler with method="grid" (the lattice
    categorical, on a skew5 static gather), 300 contours from the port's
    generator and from JAX's key on the same prior and prediction: of the
    21 x 5 per-landmark mean and covariance comparisons, at most 2 beyond 3
    standard errors of the difference (each exceeds it with probability
    0.27% when the laws are equal) and none beyond 4.5. (The esn method is
    held the same way on the whole slice's samples below.)"""
    from test_torch_port_skew_dist import moment_z_scores

    train, mu, cov, alpha = _prior_and_prediction()
    kw = dict(skew_indices=[0, 5, 10, 15, 20], image_extent=float(SIZE - 1), method="grid")
    n = 300
    jsampler = JSkewPSM(j_fit(train), **kw)
    ref = np.asarray(jax.jit(lambda k, m, c, a: jsampler.sample_batch(k, m, c, a, n=n))(
        jax.random.key(1), *(jnp.asarray(x) for x in (mu, cov, alpha))))
    sampler = SkewPosteriorShapeModelSampler(fit_shape_prior(train), device="cpu", **kw)
    got = sampler.sample_batch(torch.Generator().manual_seed(1),
                               *(torch.as_tensor(x) for x in (mu, cov, alpha)), n=n).numpy()
    assert got.shape == ref.shape == (1, n, 21, 2)
    z = moment_z_scores(got[0].transpose(1, 0, 2).astype(np.float64),
                        ref[0].transpose(1, 0, 2).astype(np.float64))
    assert z.size == 105
    assert (z > 3.0).sum() <= 2 and z.max() < 4.5, np.sort(z)[-5:]


T_A = 128


class _ViewBias:
    """The fixed logit map of each frame of the test views, looked up by
    the frame's image (nearest stored image), in either framework."""

    def __init__(self, views):
        imgs = np.concatenate([v["img"] for v in views])
        contours = np.concatenate([v["contour"] for v in views])
        yy, xx = np.mgrid[0:SIZE, 0:SIZE]
        self.imgs = imgs
        self.bias = (-((xx - contours[..., 0, None, None]) ** 2
                       + (yy - contours[..., 1, None, None]) ** 2) / (2 * 1.5 ** 2)
                     ).astype(np.float32)

    def jax(self, x):
        idx = jnp.argmin(jnp.abs(jnp.asarray(self.imgs)[None] - x[:, None]).sum((2, 3, 4)), 1)
        return jnp.asarray(self.bias)[idx]

    def torch(self, x):
        idx = (torch.as_tensor(self.imgs)[None] - x[:, None]).abs().sum((2, 3, 4)).argmin(1)
        return torch.as_tensor(self.bias)[idx]


def _generator_landmarks(n_patients, size, seed):
    """synthetic_camus_data's films with the generating contours as their
    landmarks (make_camus_tree's draws again, in its order) instead of the
    ones extracted from the masks. On the extracted ones the port's
    projected mode lies one profile-grid index (0.0067 px) from JAX's at one
    landmark, a near tie of the grid argmax that test_skew_umap_matches_jax
    allows and this module's 1e-3 px bar does not."""
    data = synthetic_camus_data(n_patients=n_patients, size=size, seed=seed)
    views = {v.id: v for split in ("train", "val", "test") for v in data.load_split(split)}
    rng = np.random.default_rng(seed)
    for p in range(1, n_patients + 1):
        for name in ("2CH", "4CH"):
            views[f"patient{p:04d}/{name}"].contour = np.stack(
                [make_sample(rng, 21, size)[2] for _ in range(2)])
    return data


@pytest.fixture(scope="module")
def slice_outputs(tmp_path_factory):
    """run_predict of both packages on the same synthetic views (5
    patients: 2 test views of 2 frames), the same weights (the port's
    seeded SkewUNet, put on the flax tree), the same training contours, T_e
    = 1 (deterministic forward), T_a = 128, the esn skew PSM sampler, and
    the `skewness` processor (the JAX package's figure switched off)."""
    import matplotlib.pyplot as plt

    from contouring_uncertainty_tpu.predict import run_predict as j_run_predict
    from test_torch_port_skew_model import torch_to_flax_params

    data = _generator_landmarks(n_patients=5, size=SIZE, seed=2)
    views = list(data.predict_views("test"))
    bias = _ViewBias(views)
    j_dir, t_dir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    cfg = {"seed": 3, "task": {"grid_window": 64, "skew_method": "esn"},
           "data": {"results_processors": ["skewness"]}}

    jtask = JSkew(data_params=JDataParams(in_shape=(1, SIZE, SIZE), out_shape=(21, 2)),
                  t_e=1, t_a=T_A, model_kwargs=SMALL)
    junet = jtask.build_model()

    class JBiased:
        def apply(self, v, x, **kw):
            out = dict(junet.apply(v, x, **kw))
            return {**out, "out": out["out"] + bias.jax(x)}

    task = DSNTSkew(data_params=data.data_params, t_e=1, t_a=T_A, model_kwargs=SMALL)
    model = task.build_model(device="cpu", generator=torch.Generator().manual_seed(6))
    shapes = jax.eval_shape(junet.init, jax.random.key(0), jnp.zeros((2, 1, SIZE, SIZE)))
    variables = {"params": jax.tree.map(jnp.asarray,
                                        torch_to_flax_params(model.state_dict(), shapes))}

    class TBiased(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.unet = model

        def forward(self, x, **kw):
            out = model(x, **kw)
            return {**out, "out": out["out"] + bias.torch(x)}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(plt, "savefig", lambda *args, **kwargs: None)
        mp.setattr(jtask, "build_model", lambda: JBiased())
        ref = j_run_predict(jtask, variables, data, {**cfg, "results_dir": str(j_dir)})
    got_metrics = {}
    got = tpred.run_predict(task, TBiased(), data, {**cfg, "results_dir": str(t_dir)},
                            device="cpu", metrics_out=got_metrics)
    return got, ref, got_metrics, t_dir, j_dir


def test_slice_deterministic_outputs_match_jax(slice_outputs):
    """Outputs fixed by the forward, per view: every BatchResult field the
    JAX package fills is filled with its shape and dtype; mu within 1e-4
    px; cov within 1e-3 of its scale; alpha (T_e-averaged, y flipped)
    within 1e-4 of its scale; the skew umap's projected mode within 1e-3 px
    and the uncertainty map within 1e-5 on all but 0.5% of the pixels (as
    test_skew_umap_matches_jax); the prediction, the mode's mask, equal but
    for at most 0.5% of the mask's pixels."""
    got, ref, *_ = slice_outputs
    assert [r.id for r in got] == [r.id for r in ref] and len(got) == 2
    for g, r in zip(got, ref):
        for key in ("mu", "cov", "alpha", "mode", "post_mu", "post_cov", "contour_samples",
                    "pred_samples", "pred", "uncertainty_map", "entropy_map"):
            gv, rv = getattr(g, key), np.asarray(getattr(r, key))
            assert gv.shape == rv.shape and gv.dtype == rv.dtype, key
        np.testing.assert_allclose(g.mu, r.mu, atol=1e-4)
        assert np.abs(g.cov - r.cov).max() < 1e-3 * np.abs(r.cov).max()
        assert np.abs(g.alpha - r.alpha).max() < 1e-4 * np.abs(r.alpha).max()
        assert not np.array_equal(g.mode, g.mu)
        np.testing.assert_allclose(g.mode, r.mode, atol=1e-3)
        assert (r.uncertainty_map > 0).mean() > 0.05
        assert (np.abs(g.uncertainty_map - r.uncertainty_map) > 1e-5).mean() <= 5e-3
        area = r.pred.sum(axis=(1, 2))
        assert (area > 300).all()
        assert ((g.pred != r.pred).sum(axis=(1, 2)) <= 5e-3 * area).all()


def test_slice_sampled_outputs_match_jax_in_distribution(slice_outputs):
    """The sample population of the esn skew PSM sampler (T_a = 128 per
    frame, other RNG streams): of the 4 frames x 21 x 5 per-landmark mean
    and covariance comparisons of the contour samples, at most 4 beyond 3
    standard errors of the difference (1.1 expected when the laws are
    equal) and none beyond 4.5; post_mu within 5 joint standard errors per
    coordinate, each frame's summed posterior variance within 25%, and the
    summed entropy within 15%, the bars of the Gaussian slice's test
    (tests/test_torch_port_predict.py)."""
    from test_torch_port_skew_dist import moment_z_scores

    got, ref, *_ = slice_outputs
    samples = [np.concatenate([np.asarray(v.contour_samples)[:, 0] for v in views])
               for views in (got, ref)]  # (4, T_a, K, 2)
    z = moment_z_scores(*(s.transpose(0, 2, 1, 3).astype(np.float64) for s in samples))
    assert z.size == 420
    assert (z > 3.0).sum() <= 4 and z.max() < 4.5, np.sort(z)[-6:]
    for g, r in zip(got, ref):
        var_j = np.einsum("nkii->nki", r.post_cov)
        var_t = np.einsum("nkii->nki", g.post_cov)
        assert (np.abs(g.post_mu - r.post_mu) < 5 * np.sqrt((var_j + var_t) / T_A)).all()
        ratio = var_t.sum(axis=(1, 2)) / var_j.sum(axis=(1, 2))
        assert (np.abs(ratio - 1.0) < 0.25).all(), ratio
        assert set(np.unique(g.pred_samples)) == {0, 1}
        ent = g.entropy_map.sum(axis=(1, 2)) / r.entropy_map.sum(axis=(1, 2))
        assert (np.abs(ent - 1.0) < 0.15).all(), ent


def test_skewness_processor_matches_jax(slice_outputs):
    """The skewness processor on both packages' results: skewness.npy's
    errors (contour - mu) within 1e-4 px and average_skew (alpha) within
    1e-4 of its scale; error_skew_x, error_skew_y (scipy's sample skewness
    of the 4 frames' errors, averaged over the landmarks) and
    mean_alpha_norm within 1e-3 relative (an f32 mu difference of 1e-5 px
    moves a 4-sample skewness by ~1e-5 of its range); no processor error;
    the JAX summary's keys."""
    from contouring_uncertainty_tpu.results import run_processors as j_run

    got, ref, got_metrics, t_dir, j_dir = slice_outputs
    assert "processor_errors" not in got_metrics
    ref_metrics = {}
    import matplotlib.pyplot as plt

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(plt, "savefig", lambda *args, **kwargs: None)
        ref_metrics = j_run(ref, j_dir, {"data": {"results_processors": ["skewness"]}})
    assert set(got_metrics) == set(ref_metrics) == {
        "skewness/error_skew_x", "skewness/error_skew_y", "skewness/mean_alpha_norm"}
    for key, value in ref_metrics.items():
        np.testing.assert_allclose(got_metrics[key], value, rtol=1e-3, err_msg=key)
    g = np.load(t_dir / "skewness.npy", allow_pickle=True).item()
    r = np.load(j_dir / "skewness.npy", allow_pickle=True).item()
    assert g["errors"].shape == r["errors"].shape == (4, 21, 2)
    np.testing.assert_allclose(g["errors"], r["errors"], atol=1e-4)
    scale = np.abs(r["average_skew"]).max()
    np.testing.assert_allclose(g["average_skew"], r["average_skew"], atol=1e-4 * scale)
