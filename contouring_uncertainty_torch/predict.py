"""Prediction / uncertainty-propagation pipeline (TMI serving path).

Counterpart of contouring_uncertainty_tpu/predict.py, Gaussian and skew,
one contour structure or several (JSRT's lungs and heart). Per view: T_e
epistemic forwards (MC dropout, encoder prefix shared) -> per-point (mu,
Sigma[, alpha]) through the DSNT moment kernel -> PSM contour sampling
(T_a per forward; the skew PSM sampler for a skew task; with
`task.sequence_sampler` the sequence samplers, which draw each forward's
(ED, ES) pair jointly) -> aleatoric/epistemic fusion -> posterior stats
of the sample population -> a label map for every sample (spline +
scanline fill of every structure through one crossing-selection launch;
with `task.soft_mask` blurred into soft masks) -> uncertainty map,
entropy map and point/instant scalars -> BatchResult. On the skew path
alpha is averaged over T_e, the skew umap gives the projected mode and the
map, and the prediction is the mode's label map.

`predict_batch_views` = V > 1 serves V views of one image shape per
dispatch (a shorter last group at its own size): one sampler call, one
rasterization and one umap for all V views.

A deep ensemble (a list of member models, as `runner` loads a directory
of `*.ckpt` members) is served by the same predictor: T_e is the member
count, each member's forward deterministic, and the DSNT head runs once
per dispatch on all members' heatmaps. A segmentation baseline takes one
model only (the JAX package fails on a member list there): `SegPredictor`
raises ValueError.

The segmentation baselines (tasks/segmentation.py) take `SegPredictor`:
the task's (T_e, T_a) probability population per view -> hole filling and
largest-blob post-processing of every sample (ops/morphology.py) ->
prediction, sample population and entropy map with a zeroed 10-px border.

Everything after the image upload runs on the predictor's device; random
draws come from a CPU `torch.Generator` per view (rng.py), so a view's
draws are the same on every device and whether or not it is batched with
others.

Several ranks (a `mesh`, parallel/mesh.py; one process per GPU) serve as
the JAX package's mesh does:

- view-parallel: `run_predict` deals each dispatch of `predict_batch_views`
  x data-size views out over the data axis, view j to data rank
  j // predict_batch_views; each view runs as it runs alone, and rank 0
  gathers every view's outputs and alone runs the results processors;
- latency mode (`__call__` with a mesh of several ranks): one view's
  Monte-Carlo chain split over every rank (parallel/serving.py): the
  forwards, the DSNT head and the sampler run whole on every rank (the
  view's draws), each rank rasterizes its share of the T_a samples per
  forward (spline and crossing selection), and the sample masks are
  gathered, so the outputs are one process's whatever the rank count. The
  JAX package also splits the MC-dropout forward's rows; here that moved
  an untrained bf16 head's mu by 0.29 px on an H100 (cuDNN rounds the tail
  convolutions otherwise at half the batch), so the port does not;
- composed (`predict_sample_parallel` = s > 1): views over the data axis,
  each view's chain over the s ranks of the model axis, as the latency
  mode splits it.
"""

from __future__ import annotations

import hashlib
import math
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from contouring_uncertainty_torch.data.config import BatchResult, Label, Tags
from contouring_uncertainty_torch.device import DeviceLike, resolve_device
from contouring_uncertainty_torch.distributions.linalg import det2x2, eigh2x2
from contouring_uncertainty_torch.ops.morphology import postprocess_batch
from contouring_uncertainty_torch.ops.rasterize import polygon_fill
from contouring_uncertainty_torch.ops.spline import contour_spline
from contouring_uncertainty_torch.parallel.distributed import (
    gather_to_rank0,
    rank0_first,
    world_size,
)
from contouring_uncertainty_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh
from contouring_uncertainty_torch.parallel.serving import SampleShard, sample_shard
from contouring_uncertainty_torch.rng import Generators
from contouring_uncertainty_torch.sampler import (
    PosteriorShapeModelSampler,
    SequencePSMSampler,
    SequenceSkewPSMSampler,
    SkewPosteriorShapeModelSampler,
    fit_shape_prior,
)
from contouring_uncertainty_torch.sampler.prior import ShapePrior, load_prior, save_prior
from contouring_uncertainty_torch.tasks.dsnt_al import is_ensemble
from contouring_uncertainty_torch.utils.projection import projected_uncertainty_value
from contouring_uncertainty_torch.utils.umap import skew_umap_groups, uncertainty_map


def get_or_fit_prior(data, path: Optional[str]) -> ShapePrior:
    """Load the shape prior cached at `path`, or fit one from the training
    contours and cache it there.

    A prior cached here carries the sha256 of the contours it was fit on:
    one fit on other contours (another data source, image size, patient
    count or seed) is refit and overwritten. A prior file without that
    digest (fit elsewhere, e.g. by the JAX package) is loaded only if it has
    the contours' dimension 2K and its mean contour lies within a tenth of
    the image's size of theirs; otherwise it raises."""
    contours = data.train_arrays("train")[Tags.contour]
    return _load_or_fit(contours, path, data.data_params.in_shape[-2:], "shape prior")


def get_or_fit_sequence_prior(data, path: Optional[str]) -> ShapePrior:
    """The two-instant (ED and ES stacked, 4K-dim) prior of the sequence
    samplers: loaded from `path`, or fit on the (ED, ES) contour pairs of
    the train split's views and cached there, keyed by the pairs' sha256
    as `get_or_fit_prior` keys its prior."""
    pairs = []
    for view in data.predict_views("train"):
        inst = view.get(Tags.instants) or {}
        if "ED" in inst and "ES" in inst and inst["ED"] != inst["ES"]:
            c = np.asarray(view[Tags.contour])
            pairs.append(np.concatenate([c[inst["ED"]], c[inst["ES"]]]))
    if not pairs:
        raise ValueError(
            "sequence_sampler=True requires views with distinct ED and ES "
            "instants to fit the two-instant shape prior, but none were found "
            "in this dataset's train split."
        )
    pairs = np.stack(pairs)
    dim = pairs.shape[1] * pairs.shape[2]
    if len(pairs) <= dim:
        print(f"[predict] the sequence prior is fit on {len(pairs)} (ED, ES) pairs, no more "
              f"than its {dim} dimensions: its covariance is singular, and the skew "
              f"sequence sampler draws NaN from it")
    return _load_or_fit(pairs, path, data.data_params.in_shape[-2:], "sequence prior")


def contour_digest(contours: np.ndarray) -> str:
    """The sha256 a cached prior is keyed by: of the contours' shape, dtype
    and bytes."""
    contours = np.ascontiguousarray(contours)
    return hashlib.sha256(f"{contours.shape} {contours.dtype}".encode()
                          + contours.tobytes()).hexdigest()


def _load_or_fit(contours: np.ndarray, path: Optional[str], image_hw, label: str) -> ShapePrior:
    """The prior of `contours` (N, 2K or 4K, 2), cached at `path` with their digest."""
    contours = np.ascontiguousarray(contours)
    digest = contour_digest(contours)
    p = Path(path) if path else None
    if p is not None and p.exists():
        with np.load(p) as stored:
            cached = str(stored["fit_digest"]) if "fit_digest" in stored.files else None
        if cached == digest:
            return load_prior(p)
        if cached is None:
            prior = load_prior(p)
            _check_foreign_prior(prior, contours, image_hw, p)
            return prior
        print(f"[predict] the {label} at {p} was fit on other training contours; refitting")
    prior = fit_shape_prior(contours)
    if p is not None:
        p.parent.mkdir(parents=True, exist_ok=True)
        save_prior(p, prior, fit_digest=digest)
    return prior


def _check_foreign_prior(prior: ShapePrior, contours: np.ndarray, image_hw, path: Path):
    flat = contours.reshape(len(contours), -1).astype(np.float64)
    if prior.dim != flat.shape[1]:
        raise ValueError(f"the shape prior at {path} has dimension {prior.dim}; the training "
                         f"contours have {flat.shape[1]}")
    shift = np.abs(prior.train_mean.double().numpy() - flat.mean(0)).max()
    if shift > 0.1 * max(image_hw):
        raise ValueError(f"the shape prior at {path} has its mean contour {shift:.1f} px from "
                         f"the training contours' mean in a {tuple(image_hw)} image: it was "
                         "fit on other data; remove it or set task.psm_path")


def fuse_epistemic_aleatoric(mu: torch.Tensor, cov: torch.Tensor):
    """(..., T_e, K, 2) means + (..., T_e, K, 2, 2) covs -> fused (..., K, 2)/
    (..., K, 2, 2): cov = mean_t(cov) + cov_t(mu) (aleatoric + epistemic)."""
    mu_mean = mu.mean(dim=-3)
    cov_al = cov.mean(dim=-4)
    d = mu - mu_mean.unsqueeze(-3)
    cov_ep = (d[..., :, None] * d[..., None, :]).mean(dim=-4)
    return mu_mean, cov_al + cov_ep


def population_posterior(samples: torch.Tensor):
    """Sample-population stats: (..., T_e, T_a, K, 2) -> post_mu (..., K, 2),
    post_cov (..., K, 2, 2) (per-T_e sample covariances + epistemic spread)."""
    post_mu_te = samples.mean(dim=-3)  # (..., T_e, K, 2)
    d = samples - post_mu_te.unsqueeze(-3)
    denom = max(samples.shape[-3] - 1, 1)
    post_cov_te = (d[..., :, None] * d[..., None, :]).sum(dim=-4) / denom
    post_mu = post_mu_te.mean(dim=-3)
    dd = post_mu_te - post_mu.unsqueeze(-3)
    post_cov_ep = (dd[..., :, None] * dd[..., None, :]).mean(dim=-4)
    return post_mu, post_cov_te.mean(dim=-4) + post_cov_ep


def sample_entropy_map(pred_samples: torch.Tensor) -> torch.Tensor:
    """Binary entropy (base 2) of the sample-mask population (..., T_e, T_a, H, W)."""
    p = pred_samples.mean(dim=(-4, -3))
    ent = -(p * torch.log2(p + 1e-12) + (1 - p) * torch.log2(1 - p + 1e-12))
    return torch.where(torch.isfinite(ent), ent, torch.zeros_like(ent))


def gaussian_blur(masks: torch.Tensor, sigma: float = 5.0, truncate: float = 1.0) -> torch.Tensor:
    """The soft-mask option (the reference's skimage gaussian + min-max):
    a separable Gaussian blur of f32 masks over their trailing (H, W), W
    first, radius int(truncate * sigma + 0.5) with zero padding (numpy's
    'same' convolution), then each mask min-max scaled with a 1e-8 floor."""
    radius = int(truncate * sigma + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=masks.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    out = F.conv2d(masks.reshape(-1, 1, *masks.shape[-2:]), k.view(1, 1, 1, -1),
                   padding=(0, radius))
    out = F.conv2d(out, k.view(1, 1, -1, 1), padding=(radius, 0))
    lo = out.amin(dim=(-2, -1), keepdim=True)
    hi = out.amax(dim=(-2, -1), keepdim=True)
    return ((out - lo) / torch.clamp(hi - lo, min=1e-8)).reshape(masks.shape)


def point_instant_uncertainty(mu, cov, post_cov, umap, entropy, pred, groups=None):
    """Scalar uncertainty derivations; `cov_projection` is the sum of the
    projections of the (start, end, label) landmark slices `groups` (by
    default one structure)."""
    if groups is None:
        groups = ((0, mu.shape[-2], 1),)

    def cov_scalars(c, prefix):
        vals, _ = eigh2x2(c)
        sq = torch.sqrt(torch.clamp(vals, min=0.0))
        return {
            f"{prefix}cov_xx": torch.sqrt(c[..., 0, 0]),
            f"{prefix}cov_yy": torch.sqrt(c[..., 1, 1]),
            f"{prefix}cov_det": torch.clamp(det2x2(c), min=0.0) ** 0.25,
            f"{prefix}cov_eigval_sum": sq.sum(-1),
        }

    point_u = cov_scalars(cov, "")
    if post_cov is not None:
        point_u.update(cov_scalars(post_cov, "post_"))
    vals, _ = eigh2x2(cov)
    sq = torch.sqrt(torch.clamp(vals, min=0.0))
    # Floor at 1 px: an empty prediction yields 0 mean-uncertainty scalars.
    mask_area = torch.clamp((pred != int(Label.BG)).sum(dim=(-2, -1)), min=1)
    instant_u = {
        "cov_det_mean": point_u["cov_det"].mean(-1),
        "cov_eigenvalue_mean": sq.mean(dim=(-1, -2)),
        "cov_projection": sum(projected_uncertainty_value(mu[..., a:b, :], cov[..., a:b, :, :])
                              for a, b, _ in groups),
        "umap_mean": umap.sum(dim=(-2, -1)) / mask_area,
    }
    if entropy is not None:
        instant_u["entropy_mean"] = entropy.sum(dim=(-2, -1)) / mask_area
    return point_u, instant_u


def rasterize_labelmap(points: torch.Tensor, groups, height: int, width: int,
                       n_dense: int = 1024) -> torch.Tensor:
    """(..., K, 2) landmarks of the (start, end, label) structures `groups`
    -> (..., H, W) f32 label map. Each structure is splined to a closed
    polygon of `n_dense` vertices (as `rasterize_batch`) and all of them
    are filled in one `polygon_fill` call, so one crossing-selection
    launch; the masks are painted in descending label order, the first as
    mask * label and each next where it is set, so the lowest label wins
    overlaps (JSRT: the lungs over the heart; CAMUS: the LV over the MYO)."""
    dense = torch.stack([contour_spline(points[..., a:b, :], n=n_dense, close=False)
                         for a, b, _ in groups])
    masks = polygon_fill(dense, height, width)  # (G, ..., H, W)
    out = None
    for i in sorted(range(len(groups)), key=lambda i: -groups[i][2]):
        label = float(groups[i][2])
        out = masks[i] * label if out is None else torch.where(masks[i] > 0, label, out)
    return out


def structure_umap_sum(umaps: List[torch.Tensor]) -> torch.Tensor:
    """The uncertainty map of a view from its structures' (..., H, W) maps:
    one structure's as it is; several, each divided by its own maximum
    (floored at 1e-12), summed and clipped to [0, 1]."""
    if len(umaps) == 1:
        return umaps[0]
    total = sum(u / torch.clamp(u.amax(dim=(-2, -1), keepdim=True), min=1e-12) for u in umaps)
    return torch.clamp(total, 0.0, 1.0)


class AleatoricPredictor:
    """Uncertainty propagation for the DSNT contour tasks: DSNT-AL with the
    Gaussian PSM sampler, DSNT-skew (a task whose `predict` also returns
    alpha) with the skew one, or either with a sequence sampler; hard or
    (`soft_mask`, one structure only) soft sample masks. `__call__` serves
    one view, `batched` V views in one dispatch.

    `contour_groups` splits the landmark vector into structures as
    (start, end, label) slices (JSRT: right lung, left lung, heart). The
    sample masks, the prediction and the skew mode are label maps
    (`rasterize_labelmap`: the lowest label wins overlaps). With more than
    one structure, each structure's uncertainty map is divided by its own
    maximum and the clipped sum is the view's map, the Gaussian prediction
    is the label map of the fused mean instead of the samples' majority
    vote, and `cov_projection` sums the structures' projections.

    With a `mesh` of several ranks, `__call__` splits the view's chain over
    every rank (the latency mode) and `batched` over the mesh's model axis
    (the composed mode); every rank of the group returns the whole
    outputs."""

    def __init__(self, task, model, sampler, t_a: Optional[int] = None,
                 soft_mask: bool = False, contour_groups=None,
                 device: DeviceLike = None, mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.task = task
        # One model, or a deep ensemble's members as a list.
        self.model = ([m.to(self.device).eval() for m in model] if is_ensemble(model)
                      else model.to(self.device).eval())
        self.sampler = sampler
        self.t_a = t_a or task.t_a
        self.soft_mask = soft_mask
        k = task.data_params.out_shape[0]
        self.groups = tuple(tuple(g) for g in contour_groups) if contour_groups else ((0, k, 1),)
        if soft_mask and len(self.groups) > 1:
            raise ValueError("soft_mask requires a single structure; the data has "
                             f"{len(self.groups)} contour groups")

    @torch.inference_mode()
    def __call__(self, img, generator: Optional[torch.Generator] = None) -> Dict:
        """img (N, C, H, W) -> dict of device tensors for one view."""
        return _tree_map(lambda a: a[0], self._serve(np.asarray(img)[None], [generator],
                                                     sample_shard(self.mesh)))

    @torch.inference_mode()
    def batched(self, imgs, generators: Generators) -> Dict:
        """imgs (V, N, C, H, W) and V generators, one per view -> the dict of
        `__call__` with a leading view axis. Each view draws from its own
        generator exactly what it draws alone."""
        return self._serve(imgs, generators, sample_shard(self.mesh, (MODEL_AXIS,)))

    def _serve(self, imgs, generators: Generators, shard: SampleShard) -> Dict:
        """`batched` with each view's chain split over `shard`."""
        imgs = torch.as_tensor(np.asarray(imgs, np.float32)).to(self.device)
        h, w = imgs.shape[-2:]
        mu_te, cov_te, *skew = self.task.predict(self.model, imgs, generator=generators)
        alpha_te = skew[0] if skew else None
        sample_kw = {} if alpha_te is None else {"alpha": alpha_te}
        samples = self.sampler.sample_batch(generators, mu_te, cov_te, n=self.t_a, **sample_kw)
        mu, cov = fuse_epistemic_aleatoric(mu_te, cov_te)  # (V, N, K, 2)
        post_mu, post_cov = population_posterior(samples)

        # (V, N, T_e, T_a, H, W): this rank's T_a share, then all of them.
        labels = rasterize_labelmap(shard.take(samples, -3), self.groups, h, w)
        if self.soft_mask:
            occupancy = shard.gather(gaussian_blur((labels > 0).to(torch.float32)), -3,
                                     self.t_a)
        else:
            labels = shard.gather(labels.to(torch.uint8), -3, self.t_a)
            occupancy = (labels > 0).to(torch.float32)
        frames = lambda a: a.flatten(0, 1)  # (V, N, ...) -> (V*N, ...)
        lead = mu.shape[:2]
        if alpha_te is None:
            alpha, mode = None, mu
            umap = structure_umap_sum([
                uncertainty_map(frames(mu[..., a:b, :]), frames(cov[..., a:b, :, :]), (h, w))
                for a, b, _ in self.groups]).unflatten(0, lead)
            if len(self.groups) == 1:
                pred = torch.where(occupancy.mean(dim=(-4, -3)) > 0.5, self.groups[0][2], 0)
            else:
                pred = rasterize_labelmap(mu, self.groups, h, w)
        else:
            alpha = alpha_te.mean(dim=-3)
            parts = skew_umap_groups(frames(mu), frames(cov), frames(alpha), self.groups, (h, w))
            mode = torch.cat([m for m, _ in parts], dim=-2).unflatten(0, lead)
            umap = structure_umap_sum([u for _, u in parts]).unflatten(0, lead)
            pred = rasterize_labelmap(mode, self.groups, h, w)
        pred = pred.to(torch.int32)
        entropy = sample_entropy_map(occupancy)
        point_u, instant_u = point_instant_uncertainty(mu, cov, post_cov, umap,
                                                       entropy, pred, self.groups)
        # Hard-mask populations hold small integer labels: ship them as
        # uint8. Soft masks stay f32 in [0, 1].
        pred_samples = occupancy if self.soft_mask else labels
        return {
            "mu": mu, "cov": cov, "mode": mode, "alpha": alpha,
            "post_mu": post_mu, "post_cov": post_cov,
            "contour_samples": samples, "pred_samples": pred_samples,
            "pred": pred, "uncertainty_map": umap, "entropy_map": entropy,
            "point_uncertainty": point_u, "instant_uncertainty": instant_u,
        }


class SegPredictor:
    """Prediction for the segmentation baselines: `__call__` serves one
    view, `batched` V views in one dispatch (the forwards per view, as the
    task's `predict_probs` runs them; everything after once).

    Binary (one channel): the sample probabilities rounded (half to even,
    as `jnp.round`), post-processed, and the probabilities masked by the
    result; the prediction is the rounded mean, the entropy the binary
    entropy (base 2) of the masked population. Multiclass: the argmax of
    the mean probabilities, their entropy in base C, and the samples as
    label maps cleaned by the post-processing of their foreground union
    (the prediction too). Both zero a BORDER_PAD-px border of the entropy
    and report its mean over the predicted area.

    With a `mesh` of several ranks, `__call__` (every rank) and `batched`
    (the model axis) split the post-processing of the (T_e, T_a) sample
    masks over the ranks and gather them; the forwards run whole on every
    rank."""

    BORDER_PAD = 10

    def __init__(self, task, model, device: DeviceLike = None, mesh: Optional[Mesh] = None):
        if is_ensemble(model):
            raise ValueError(f"the segmentation task {task.task_name!r} takes one model, not a "
                             f"deep ensemble of {len(model)} members")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.task = task
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def __call__(self, img, generator: Optional[torch.Generator] = None) -> Dict:
        """img (N, C, H, W) -> dict of device tensors for one view."""
        return _tree_map(lambda a: a[0], self._serve(np.asarray(img)[None], [generator],
                                                     sample_shard(self.mesh)))

    @torch.inference_mode()
    def batched(self, imgs, generators: Generators) -> Dict:
        """imgs (V, N, C, H, W) and V generators -> the dict of `__call__`
        with a leading view axis."""
        return self._serve(imgs, generators, sample_shard(self.mesh, (MODEL_AXIS,)))

    def _serve(self, imgs, generators: Generators, shard: SampleShard) -> Dict:
        imgs = torch.as_tensor(np.asarray(imgs, np.float32)).to(self.device)
        # (V, N, T_e, T_a, C, H, W)
        probs = self.task.predict_probs(self.model, imgs, generators)
        c = probs.shape[-3]

        def postprocess(masks):  # (V, N, T_e, T_a, H, W), this rank's share of the samples
            flat = masks.flatten(2, 3)
            kept = shard.gather(postprocess_batch(shard.take(flat, 2)), 2, flat.shape[2])
            return kept.unflatten(2, masks.shape[2:4])

        if c == 1:
            samples = probs[..., 0, :, :]
            samples = samples * postprocess(torch.round(samples))
            pred = torch.round(samples.mean(dim=(-4, -3))).to(torch.int32)
            entropy = sample_entropy_map(samples)
        else:
            mean_probs = probs.mean(dim=(-5, -4))  # (V, N, C, H, W)
            pred = torch.argmax(mean_probs, dim=-3).to(torch.int32)
            entropy = -(mean_probs * torch.log(mean_probs + 1e-12)).sum(dim=-3) / math.log(c)
            samples = torch.argmax(probs, dim=-3).to(torch.float32)
            samples = samples * postprocess((samples > 0).to(torch.float32))
            pred = (pred * postprocess_batch((pred > 0).to(torch.float32))).to(torch.int32)
        pad = self.BORDER_PAD
        border = torch.zeros(entropy.shape[-2:], dtype=torch.bool, device=self.device)
        border[pad:-pad, pad:-pad] = True
        entropy = entropy * border
        mask_area = torch.clamp((pred != 0).sum(dim=(-2, -1)), min=1)
        return {"pred": pred, "pred_samples": samples, "uncertainty_map": entropy,
                "entropy_map": entropy,
                "instant_uncertainty": {"entropy_mean": entropy.sum(dim=(-2, -1)) / mask_area}}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _to_numpy(tree):
    return _tree_map(lambda a: a.detach().cpu().numpy(), tree)


def view_generator(seed: int, view_index: int) -> torch.Generator:
    """The CPU generator of one view, mixed from (seed, view index)."""
    state = np.random.SeedSequence([int(seed), int(view_index)]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def views_per_step(cfg: Dict) -> int:
    """`predict_batch_views`: the views served per dispatch (at least 1)."""
    return max(int(cfg.get("predict_batch_views", 1) or 1), 1)


def _run_predictor(predictor, views, seed: int,
                   per_step: int = 1) -> Optional[List[Dict]]:
    """Run a predictor over a view list, `per_step` views of one image shape
    per dispatch; a short last group is dispatched at its own size. Each
    view draws from `view_generator(seed, its index)` and runs its forward
    alone, so its outputs match one view per dispatch up to the
    reassociation of the batched steps after the forward.

    With the predictor's mesh of d data ranks, each chunk of per_step * d
    views is dealt out over the data axis (view j of a chunk to data rank
    j // per_step; a rank past a ragged tail sits the chunk out), and the
    outputs are gathered to rank 0, which returns them in view order; the
    other ranks return None."""
    mesh = predictor.mesh
    d = mesh.shape[DATA_AXIS] if mesh is not None else 1
    mine_at = mesh.index(DATA_AXIS) * per_step if mesh is not None else 0
    groups: Dict[tuple, List[int]] = {}
    for vi, v in enumerate(views):
        groups.setdefault(tuple(np.asarray(v[Tags.img]).shape), []).append(vi)
    outs: Dict[int, Dict] = {}
    for idxs in groups.values():
        for start in range(0, len(idxs), per_step * d):
            chunk = idxs[start:start + per_step * d][mine_at:mine_at + per_step]
            if not chunk:
                continue
            out = _to_numpy(predictor.batched(
                np.stack([views[i][Tags.img] for i in chunk]),
                [view_generator(seed, i) for i in chunk]))
            for j, i in enumerate(chunk):
                outs[i] = _tree_map(lambda a, j=j: a[j], out)
    if mesh is not None and mesh.size > 1:
        # The ranks of a model group hold the same views: one of them sends.
        parts = gather_to_rank0(outs if mesh.index(MODEL_AXIS) == 0 else {})
        if parts is None:
            return None
        outs = {i: out for part in parts for i, out in part.items()}
    return [outs[i] for i in range(len(views))]


def predict_mesh_mode(cfg: Dict) -> str:
    """`predict_mesh` as the JAX runner reads it: "auto" (also true, 1, yes,
    on; the default) or "false" (also 0, no, off); anything else raises
    ValueError."""
    raw = cfg.get("predict_mesh", "auto")
    sel = str(raw).strip().lower()
    if sel in ("true", "1", "yes", "on"):
        return "auto"
    if sel in ("false", "0", "no", "off"):
        return "false"
    if sel != "auto":
        raise ValueError(f"predict_mesh={raw!r} not understood — use 'auto', true, or false")
    return sel


def check_predict_options(cfg: Dict):
    """Raise, as the JAX runner does, on a `predict_mesh` value it refuses
    and, where predict would serve on a mesh of several ranks, on a
    `predict_sample_parallel` that does not divide them (with one rank it
    is ignored)."""
    if predict_mesh_mode(cfg) == "auto" and world_size() > 1:
        s = int(cfg.get("predict_sample_parallel", 1) or 1)
        if world_size() % s:
            raise ValueError(f"predict_sample_parallel={s} must divide the device count "
                             f"({world_size()})")


def predict_mesh(cfg: Dict) -> Optional[Mesh]:
    """The serving mesh of the JAX runner: with `predict_mesh` auto and
    several ranks, every rank, `predict_sample_parallel` of them on the
    model axis (views x samples); None otherwise (one rank serves alone).
    Every rank must call it, with options `check_predict_options` passed."""
    if predict_mesh_mode(cfg) == "auto" and world_size() > 1:
        return make_mesh(model_parallel=int(cfg.get("predict_sample_parallel", 1) or 1))
    return None


def _rank0_first(fn, mesh: Optional[Mesh]):
    """fn() on rank 0 first when a mesh of several ranks serves (it fills a
    cache file the others then read), else fn()."""
    return rank0_first(fn) if mesh is not None and mesh.size > 1 else fn()


def run_predict_segmentation(task, model, data, cfg, split: str = "test",
                             device: DeviceLike = None,
                             mesh: Optional[Mesh] = None) -> List[BatchResult]:
    """`SegPredictor` over every view of the split -> BatchResults (on rank
    0 of a mesh; [] on its other ranks)."""
    predictor = SegPredictor(task, model, device=device, mesh=mesh)
    views = list(data.predict_views(split))
    outs = _run_predictor(predictor, views, cfg.get("seed", 10), views_per_step(cfg))
    if outs is None:
        return []
    return [BatchResult(
        id=view[Tags.id],
        labels=task.data_params.labels,
        img=np.asarray(view[Tags.img]),
        gt=np.asarray(view[Tags.gt]) if view.get(Tags.gt) is not None else None,
        pred=out["pred"],
        pred_samples=out["pred_samples"],
        uncertainty_map=out["uncertainty_map"],
        entropy_map=out["entropy_map"],
        instant_uncertainty=out["instant_uncertainty"],
        voxelspacing=view.get(Tags.voxelspacing),
        instants=view.get(Tags.instants),
        image_quality=view.get(Tags.image_quality),
    ) for view, out in zip(views, outs)]


def run_predict(task, model, data, cfg, split: str = "test",
                device: DeviceLike = None,
                metrics_out: Optional[Dict] = None,
                mesh: Optional[Mesh] = None) -> List[BatchResult]:
    """Predict every view of the split and assemble BatchResults, then run
    the results processors when `cfg` has `results_dir` or `save_path`.

    `model` is the task's backbone with its weights (task.build_model()),
    or a deep ensemble: a list of such models, T_e = its length;
    `cfg` is a dict with optional "seed", "predict_batch_views", "task":
    {"psm_path", "sequence_sampler", "seq_psm_path", "soft_mask", and for a
    skew task "grid_window" and "skew_method"} and the processors' "data":
    {"results_processors": [...]}. The processors' summary,
    `processor_errors` included, is merged into `metrics_out`. A
    segmentation baseline is served by `SegPredictor` and fits no prior.

    `mesh` (every rank calls run_predict with it; `predict_mesh(cfg)`
    builds the runner's) serves the views over its ranks: rank 0 returns
    every view's BatchResult and runs the processors, the other ranks
    return []. Rank 0 fits and caches the priors before the others load
    them."""
    from contouring_uncertainty_torch.tasks.segmentation import SegmentationUncertaintyTask

    device = resolve_device(device)
    task_cfg = cfg.get("task", {})
    predict_mesh_mode(cfg)
    if isinstance(task, SegmentationUncertaintyTask):
        results = run_predict_segmentation(task, model, data, cfg, split, device, mesh)
        if mesh is None or mesh.rank == 0:
            _maybe_run_processors(results, cfg, metrics_out, device)
        return results
    prior = _rank0_first(lambda: get_or_fit_prior(data, task_cfg.get("psm_path")), mesh)
    skew_task = hasattr(task, "forward_skew")
    # The lattice of the 'grid' method covers the image's extent.
    in_h, in_w = task.data_params.in_shape[1:]
    skew_kw = dict(skew_indices=getattr(task, "skew_indices", None),
                   image_extent=float(max(in_h, in_w) - 1),
                   grid_window=task_cfg.get("grid_window", 64),
                   method=task_cfg.get("skew_method", "esn"), device=device)
    sequence = bool(task_cfg.get("sequence_sampler", False))
    if sequence:
        seq_prior = _rank0_first(
            lambda: get_or_fit_sequence_prior(data, task_cfg.get("seq_psm_path")), mesh)
        sampler = (SequenceSkewPSMSampler(prior, seq_prior, **skew_kw) if skew_task
                   else SequencePSMSampler(prior, seq_prior, device=device))
    elif skew_task:
        sampler = SkewPosteriorShapeModelSampler(prior, **skew_kw)
    else:
        sampler = PosteriorShapeModelSampler(prior, device=device)
    predictor = AleatoricPredictor(task, model, sampler,
                                   soft_mask=bool(task_cfg.get("soft_mask", False)),
                                   contour_groups=getattr(data, "contour_groups", None),
                                   device=device, mesh=mesh)
    views = list(data.predict_views(split))
    if sequence:
        for view in views:
            frames = np.asarray(view[Tags.img]).shape[0]
            if frames != 2:
                raise ValueError(
                    f"sequence_sampler=True expects exactly 2 instants (ED, ES) per view; "
                    f"view '{view[Tags.id]}' has {frames} frames. Disable "
                    f"task.sequence_sampler or restrict views to ED/ES.")
    outs = _run_predictor(predictor, views, cfg.get("seed", 10), views_per_step(cfg))
    if outs is None:
        return []
    results = []
    for view, out in zip(views, outs):
        results.append(BatchResult(
            id=view[Tags.id],
            labels=task.data_params.labels,
            img=np.asarray(view[Tags.img]),
            gt=np.asarray(view[Tags.gt]) if view.get(Tags.gt) is not None else None,
            contour=(np.asarray(view[Tags.contour])
                     if view.get(Tags.contour) is not None else None),
            pred=out["pred"],
            mu=out["mu"],
            mode=out["mode"],
            cov=out["cov"],
            alpha=out["alpha"],
            post_mu=out["post_mu"],
            post_cov=out["post_cov"],
            contour_samples=out["contour_samples"],
            pred_samples=out["pred_samples"],
            uncertainty_map=out["uncertainty_map"],
            entropy_map=out["entropy_map"],
            point_uncertainty=out["point_uncertainty"],
            instant_uncertainty=out["instant_uncertainty"],
            voxelspacing=view.get(Tags.voxelspacing),
            instants=view.get(Tags.instants),
            image_quality=view.get(Tags.image_quality),
        ))
    _maybe_run_processors(results, cfg, metrics_out, device)
    return results


def _maybe_run_processors(results, cfg, metrics_out=None, device: DeviceLike = None):
    if cfg.get("results_dir") or cfg.get("save_path"):
        out_dir = Path(cfg.get("results_dir") or Path(cfg["save_path"]) / "results")
        from contouring_uncertainty_torch.results import run_processors

        metrics = run_processors(results, out_dir, cfg, device=device)
        if metrics_out is not None:
            metrics_out.update(metrics)
