"""PyTorch port vs JAX package: the sequence (ED <-> ES) samplers, the
sequence prior and the soft-mask blur (sampler/sequence.py,
predict.py `get_or_fit_sequence_prior`, `gaussian_blur`).

Both sides get the same numpy inputs. The samplers draw from different
RNG streams (the JAX sampler splits a key per pair and per level), so
their populations are compared in distribution; the deterministic parts
(the sequence posterior, the prior, the blur) are compared directly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu import predict as jpred
from contouring_uncertainty_tpu.sampler import fit_shape_prior as j_fit
from contouring_uncertainty_tpu.sampler.sequence import SequencePSMSampler as JSeq
from contouring_uncertainty_tpu.sampler.sequence import SequenceSkewPSMSampler as JSeqSkew
from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch.data.config import Tags
from contouring_uncertainty_torch.data.synthetic import lv_contour_points, synthetic_camus_data
from contouring_uncertainty_torch.rng import draw_normal, draw_uniform
from contouring_uncertainty_torch.sampler import fit_shape_prior
from contouring_uncertainty_torch.sampler.sequence import (
    SequencePSMSampler,
    SequenceSkewPSMSampler,
)

torch.set_num_threads(1)

SIZE = 64
SAMPLERS = {"gaussian": (JSeq, SequencePSMSampler, {}),
            "skew": (JSeqSkew, SequenceSkewPSMSampler, {"image_extent": float(SIZE - 1)})}


@pytest.fixture(scope="module")
def pairs():
    """150 synthetic ED contours at 64^2 and their ES, each ED shrunk by 0.8
    about its centroid (the JAX package's sequence sampler test data)."""
    rng = np.random.default_rng(1)
    ed = np.stack([lv_contour_points(rng, k=21, size=SIZE) for _ in range(150)])
    centre = ed.mean(axis=1, keepdims=True)
    return ed, centre + (ed - centre) * 0.8


def _priors(ed, es, fit):
    return fit(np.concatenate([ed, es])), fit(np.concatenate([ed, es], axis=1))


@pytest.mark.parametrize("first", ["ED", "ES"])
@pytest.mark.parametrize("variant", list(SAMPLERS))
def test_sequence_posterior_matches_jax(variant, first, pairs):
    """The sequence posterior of the second instant given a sampled first
    instant, for both first-instant choices, Gaussian (fixed prior, no refit
    column) and skew (floored factor, refit around the prediction): mu_c
    within 1e-5 of its scale (measured 3.3e-6); cov_c within 1e-3 of its
    scale (measured 3.9e-4), as the single-instant posterior's: the blocks
    are the f32 difference C - (MC)^T S^-1 (MC) of terms 200 times their
    size, whose rounding depends on the summation order."""
    ed, es = pairs
    j_cls, t_cls, kw = SAMPLERS[variant]
    js = j_cls(*_priors(ed, es, j_fit), **kw)
    ts = t_cls(*_priors(ed, es, fit_shape_prior), device="cpu", **kw)
    mu = np.stack([ed[7], es[7]]).astype(np.float32)
    s_first = (ed[9] + np.random.default_rng(2).normal(size=(21, 2))).astype(np.float32)
    is_ed = first == "ED"
    j_mu_t, j_d = js._seq_params(jnp.asarray(mu))
    ref_mu, ref_cov = (np.asarray(a) for a in js._sequence_posterior(
        jnp.asarray(s_first), jnp.asarray(is_ed), j_mu_t, j_d))
    t_mu_t, t_d = ts._seq_params(torch.as_tensor(mu)[None])
    got_mu, got_cov = ts._sequence_posterior(torch.as_tensor(s_first)[None, None],
                                             torch.tensor([[is_ed]]), t_mu_t, t_d)
    assert got_mu.shape == (1, 1, 2, 21, 2) and got_cov.shape == (1, 1, 2, 21, 2, 2)
    assert ref_mu.shape == (2, 21, 2) and ref_cov.shape == (2, 21, 2, 2)
    np.testing.assert_allclose(got_mu[0, 0].numpy(), ref_mu, rtol=0,
                               atol=1e-5 * np.abs(ref_mu).max())
    np.testing.assert_allclose(got_cov[0, 0].numpy(), ref_cov, rtol=0,
                               atol=1e-3 * np.abs(ref_cov).max())


def _mode_z_scores(got, ref, modes: int = 4):
    """Two (n, 2, K, 2) populations in the coordinates of each instant's top
    `modes` principal modes (a PCA of both populations pooled): the mean of
    each of the 2 x `modes` coordinates and every entry of their covariance
    (each instant's own, and the ED-ES cross-covariance), in standard errors
    of the difference. The landmarks of a shape population move together,
    so per-landmark statistics are strongly correlated; the mode
    coordinates are not."""
    coords = [[], []]
    for inst in range(2):
        flat = [p[:, inst].reshape(len(p), -1) for p in (got, ref)]
        pooled = np.concatenate(flat)
        centre = pooled.mean(0)
        _, vecs = np.linalg.eigh(np.cov(pooled - centre, rowvar=False))
        for side, f in enumerate(flat):
            coords[side].append((f - centre) @ vecs[:, ::-1][:, :modes])
    a, b = (np.concatenate(c, axis=1) for c in coords)
    z = list(np.abs(a.mean(0) - b.mean(0)) / np.sqrt(a.var(0, ddof=1) / len(a)
                                                      + b.var(0, ddof=1) / len(b)))
    ca, cb = a - a.mean(0), b - b.mean(0)
    for i in range(a.shape[1]):
        for j in range(i, a.shape[1]):
            pa, pb = ca[:, i] * ca[:, j], cb[:, i] * cb[:, j]
            se = np.sqrt(pa.var(ddof=1) / len(pa) + pb.var(ddof=1) / len(pb))
            z.append(abs(pa.mean() - pb.mean()) / se)
    return np.asarray(z)


@pytest.mark.parametrize("variant", list(SAMPLERS))
def test_sequence_samplers_match_jax_in_distribution(variant, pairs):
    """Both sequence samplers on one (ED, ES) prediction, 10,000 pairs from
    the port's generator and from JAX's key (the draws cannot be matched:
    JAX splits its key per pair, instant and level). In each instant's top
    4 shape modes, the 8 means and the 36 covariance entries (each
    instant's 10 and the 16 of the ED-ES cross-covariance) lie within 3
    standard errors of the difference, except at most 2 (each exceeds it
    with probability 0.27% when the laws are equal), and none beyond 4.5.
    The instants stay coupled: ES's mean area below ED's, and each
    instant's mean within 8 px of its prediction, as in the JAX package's
    test."""
    ed, es = pairs
    j_cls, t_cls, kw = SAMPLERS[variant]
    mu = np.stack([ed[7], es[7]]).astype(np.float32)
    cov = np.tile((np.eye(2) * 4.0).astype(np.float32), (2, 21, 1, 1))
    alpha = np.full((2, 21, 2), 2.0, np.float32) if variant == "skew" else None
    n = 10_000
    js = j_cls(*_priors(ed, es, j_fit), **kw)
    j_alpha = None if alpha is None else jnp.asarray(alpha)
    ref = np.asarray(jax.jit(lambda k, m, c: js(k, m, c, j_alpha, n=n))(
        jax.random.key(4), jnp.asarray(mu), jnp.asarray(cov)))
    ts = t_cls(*_priors(ed, es, fit_shape_prior), device="cpu", **kw)
    extra = {} if alpha is None else {"alpha": torch.as_tensor(alpha)[:, None]}
    # 20 calls of 500 pairs from one generator (a served view's call is 250
    # pairs): the port's (B, P, P) posterior temporaries stay in cache.
    gen = torch.Generator().manual_seed(4)
    got = torch.cat([ts.sample_batch(gen, torch.as_tensor(mu)[:, None],
                                     torch.as_tensor(cov)[:, None], n=n // 20, **extra)
                     for _ in range(20)], dim=2)
    assert got.shape == (2, 1, n, 21, 2) and ref.shape == (n, 2, 21, 2)
    got = got[:, 0].transpose(0, 1).numpy().astype(np.float64)
    ref = ref.astype(np.float64)
    assert np.isfinite(got).all()
    z = _mode_z_scores(got, ref)
    assert z.size == 44
    assert (z > 3.0).sum() <= 2 and z.max() < 4.5, np.sort(z)[-5:]

    def area(c):
        x, y = c[..., 0], c[..., 1]
        return 0.5 * np.abs((x * np.roll(y, -1, -1) - np.roll(x, -1, -1) * y).sum(-1))

    for pop in (got, ref):
        assert area(pop[:, 1]).mean() < area(pop[:, 0]).mean()
        for inst in range(2):
            assert np.linalg.norm(pop[:, inst].mean(0) - mu[inst], axis=-1).mean() < 8.0


def test_sequence_prior_matches_jax_and_is_cached_by_its_pairs(tmp_path, capsys):
    """get_or_fit_sequence_prior on the synthetic source: the (ED, ES) pairs
    of the train split give the JAX package's prior (means and covariance
    within 1e-5 of their scale; Q up to eigenvector signs, as Q Q^T); the
    prior is cached at the path with its pairs' digest, loaded back
    unchanged, and refit when the data change. Fit on 6 pairs, fewer than
    its 84 dimensions, it warns that its covariance is singular."""
    data = synthetic_camus_data(n_patients=5, size=SIZE, seed=1)
    path = tmp_path / "seq.npz"
    got = tpred.get_or_fit_sequence_prior(data, str(path))
    assert "fit on 6 (ED, ES) pairs, no more than its 84 dimensions" in capsys.readouterr().out
    ref = jpred.get_or_fit_sequence_prior(data, None)
    assert got.mean_shape.shape == (84,)
    for key in ("mean_shape", "train_mean", "train_scale", "x_train_mean", "cov0"):
        r = np.asarray(getattr(ref, key))
        np.testing.assert_allclose(getattr(got, key).numpy(), r, rtol=0,
                                   atol=1e-5 * max(np.abs(r).max(), 1.0), err_msg=key)
    qq = [np.asarray(q, np.float64) @ np.asarray(q, np.float64).T for q in (got.q, ref.q)]
    np.testing.assert_allclose(qq[0], qq[1], rtol=0, atol=1e-5 * np.abs(qq[1]).max())

    assert path.exists()
    capsys.readouterr()
    again = tpred.get_or_fit_sequence_prior(data, str(path))
    assert "refitting" not in capsys.readouterr().out
    for a, b in zip(again, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    other = synthetic_camus_data(n_patients=5, size=SIZE, seed=2)
    tpred.get_or_fit_sequence_prior(other, str(path))
    assert "refitting" in capsys.readouterr().out


class _OneFrameViews:
    """The synthetic source with every view cut to its ED frame."""

    def __init__(self, data):
        self.data = data
        self.data_params = data.data_params

    def train_arrays(self, split="train"):
        return self.data.train_arrays(split)

    def predict_views(self, split="test"):
        for view in self.data.predict_views(split):
            yield {**view, Tags.img: view[Tags.img][:1], Tags.contour: view[Tags.contour][:1],
                   Tags.gt: view[Tags.gt][:1], Tags.instants: {"ED": 0, "ES": 0}}


def test_sequence_errors_match_jax():
    """Both ValueErrors of the JAX package: no view with distinct ED and ES
    instants to fit the sequence prior on, and a view that is not an (ED,
    ES) pair when the sequence sampler is asked for (run_predict, before
    any forward), with the JAX package's messages."""
    from contouring_uncertainty_tpu.tasks import DSNTAleatoric as JTask
    from contouring_uncertainty_torch.tasks import DSNTAleatoric

    one = _OneFrameViews(synthetic_camus_data(n_patients=5, size=SIZE, seed=1))
    match = "requires views with distinct ED and ES instants"
    with pytest.raises(ValueError, match=match):
        tpred.get_or_fit_sequence_prior(one, None)
    with pytest.raises(ValueError, match=match):
        jpred.get_or_fit_sequence_prior(one, None)

    class OneFrameTest(_OneFrameViews):
        def predict_views(self, split="test"):
            if split == "train":
                yield from self.data.predict_views(split)
            else:
                yield from super().predict_views(split)

    data = OneFrameTest(synthetic_camus_data(n_patients=5, size=SIZE, seed=1))
    cfg = {"seed": 0, "task": {"sequence_sampler": True}}
    small = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3)
    task = DSNTAleatoric(data_params=data.data_params, model_kwargs=small)
    match = r"expects exactly 2 instants \(ED, ES\) per view; view 'patient0005/2CH' has 1"
    with pytest.raises(ValueError, match=match):
        tpred.run_predict(task, task.build_model(device="cpu"), data, cfg, device="cpu")
    jtask = JTask(data_params=data.data_params, model_kwargs=small)
    with pytest.raises(ValueError, match=match):
        jpred.run_predict(jtask, None, data, cfg)


def test_gaussian_blur_matches_jax():
    """The soft-mask blur against the JAX package's `_gaussian_blur` within
    1e-6: random binary masks, a mask filling a corner (touching two
    borders, where the zero padding shows), an all-zero mask (min-max with
    the 1e-8 floor gives zeros), over two leading axes."""
    rng = np.random.default_rng(0)
    masks = (rng.uniform(size=(2, 3, SIZE, SIZE)) > 0.5).astype(np.float32)
    masks[0, 1] = 0.0
    masks[0, 1, :20, :30] = 1.0
    masks[1, 2] = 0.0
    got = tpred.gaussian_blur(torch.as_tensor(masks)).numpy()
    ref = np.asarray(jpred._gaussian_blur(jnp.asarray(masks)))
    assert got.shape == ref.shape == masks.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got[1, 2].max() == 0.0 and got.max() == 1.0
    assert 0.0 < got[0, 1, 0, 0] < 1.0 and got[0, 1, 10, 10] == 1.0


def test_draws_split_over_view_generators():
    """A draw over V generators is each generator's own draw of its block of
    the leading axis, concatenated in order; a sequence sampler's batch of
    V views gives each view what it gives alone."""
    gens = lambda: [torch.Generator().manual_seed(s) for s in (3, 4)]
    for draw in (draw_normal, draw_uniform):
        both = draw(gens(), (6, 5))
        alone = torch.cat([draw(g, (3, 5)) for g in gens()])
        torch.testing.assert_close(both, alone, rtol=0, atol=0)
    with pytest.raises(ValueError, match="cannot be split over 2 generators"):
        draw_normal(gens(), (5, 2))

    ed = np.stack([lv_contour_points(np.random.default_rng(s), k=21, size=SIZE)
                   for s in range(40)])
    centre = ed.mean(axis=1, keepdims=True)
    es = centre + (ed - centre) * 0.8
    sampler = SequencePSMSampler(*_priors(ed, es, fit_shape_prior), device="cpu")
    mu = torch.as_tensor(np.stack([np.stack([ed[i], es[i]]) for i in (1, 2)]),
                         dtype=torch.float32)[:, :, None].repeat(1, 1, 2, 1, 1)
    cov = torch.eye(2).expand(2, 2, 2, 21, 2, 2) * 4.0
    batch = sampler.sample_batch(gens(), mu, cov, n=3)
    assert batch.shape == (2, 2, 2, 3, 21, 2)
    for v, g in enumerate(gens()):
        torch.testing.assert_close(sampler.sample_batch(g, mu[v], cov[v], n=3), batch[v],
                                   rtol=0, atol=0)
