"""Prediction / uncertainty-propagation pipeline (TMI serving path).

Counterpart of contouring_uncertainty_tpu/predict.py, Gaussian single-group
hard-mask branch. Per view: T_e epistemic forwards (MC dropout, encoder
prefix shared) -> per-point (mu, Sigma) through the DSNT moment kernel ->
PSM contour sampling (T_a per forward) -> aleatoric/epistemic fusion ->
posterior stats of the sample population -> a mask for every sample
(spline + scanline fill through the crossing-selection kernel) ->
uncertainty map, entropy map and point/instant scalars -> BatchResult.

Everything after the image upload runs on the predictor's device; random
draws come from a CPU `torch.Generator` per view, so a view's draws are
the same on every device.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from contouring_uncertainty_torch.data.config import BatchResult, Label, Tags
from contouring_uncertainty_torch.device import DeviceLike, resolve_device
from contouring_uncertainty_torch.distributions.linalg import det2x2, eigh2x2
from contouring_uncertainty_torch.ops.rasterize import rasterize_batch
from contouring_uncertainty_torch.sampler import PosteriorShapeModelSampler, fit_shape_prior
from contouring_uncertainty_torch.sampler.prior import ShapePrior, load_prior, save_prior
from contouring_uncertainty_torch.utils.projection import projected_uncertainty_value
from contouring_uncertainty_torch.utils.umap import uncertainty_map


def get_or_fit_prior(data, path: Optional[str]) -> ShapePrior:
    """Load the shape prior cached at `path`, or fit one from the training
    contours and cache it there.

    A prior cached here carries the sha256 of the contours it was fit on:
    one fit on other contours (another data source, image size, patient
    count or seed) is refit and overwritten. A prior file without that
    digest (fit elsewhere, e.g. by the JAX package) is loaded only if it has
    the contours' dimension 2K and its mean contour lies within a tenth of
    the image's size of theirs; otherwise it raises."""
    contours = np.ascontiguousarray(data.train_arrays("train")[Tags.contour])
    digest = hashlib.sha256(f"{contours.shape} {contours.dtype}".encode()
                            + contours.tobytes()).hexdigest()
    p = Path(path) if path else None
    if p is not None and p.exists():
        with np.load(p) as stored:
            cached = str(stored["fit_digest"]) if "fit_digest" in stored.files else None
        if cached == digest:
            return load_prior(p)
        if cached is None:
            prior = load_prior(p)
            _check_foreign_prior(prior, contours, data.data_params.in_shape[-2:], p)
            return prior
        print(f"[predict] the shape prior at {p} was fit on other training contours; refitting")
    prior = fit_shape_prior(contours)
    if p is not None:
        p.parent.mkdir(parents=True, exist_ok=True)
        save_prior(p, prior, fit_digest=digest)
    return prior


def _check_foreign_prior(prior: ShapePrior, contours: np.ndarray, image_hw, path: Path):
    flat = contours.reshape(len(contours), -1).astype(np.float64)
    if prior.dim != flat.shape[1]:
        raise ValueError(f"the shape prior at {path} has dimension {prior.dim}; the training "
                         f"contours have {flat.shape[1]} (2K)")
    shift = np.abs(prior.train_mean.double().numpy() - flat.mean(0)).max()
    if shift > 0.1 * max(image_hw):
        raise ValueError(f"the shape prior at {path} has its mean contour {shift:.1f} px from "
                         f"the training contours' mean in a {tuple(image_hw)} image: it was "
                         "fit on other data; remove it or set task.psm_path")


def fuse_epistemic_aleatoric(mu: torch.Tensor, cov: torch.Tensor):
    """(N, T_e, K, 2) means + (N, T_e, K, 2, 2) covs -> fused (N, K, 2)/(N, K, 2, 2):
    cov = mean_t(cov) + cov_t(mu) (aleatoric + epistemic)."""
    mu_mean = mu.mean(dim=1)
    cov_al = cov.mean(dim=1)
    d = mu - mu_mean[:, None]
    cov_ep = (d[..., :, None] * d[..., None, :]).mean(dim=1)
    return mu_mean, cov_al + cov_ep


def population_posterior(samples: torch.Tensor):
    """Sample-population stats: (N, T_e, T_a, K, 2) -> post_mu (N,K,2),
    post_cov (N,K,2,2) (per-T_e sample covariances + epistemic spread)."""
    post_mu_te = samples.mean(dim=2)  # (N, T_e, K, 2)
    d = samples - post_mu_te[:, :, None]
    denom = max(samples.shape[2] - 1, 1)
    post_cov_te = (d[..., :, None] * d[..., None, :]).sum(dim=2) / denom
    post_mu = post_mu_te.mean(dim=1)
    dd = post_mu_te - post_mu[:, None]
    post_cov_ep = (dd[..., :, None] * dd[..., None, :]).mean(dim=1)
    return post_mu, post_cov_te.mean(dim=1) + post_cov_ep


def sample_entropy_map(pred_samples: torch.Tensor) -> torch.Tensor:
    """Binary entropy (base 2) of the sample-mask population (N, T_e, T_a, H, W)."""
    p = pred_samples.mean(dim=(1, 2))
    ent = -(p * torch.log2(p + 1e-12) + (1 - p) * torch.log2(1 - p + 1e-12))
    return torch.where(torch.isfinite(ent), ent, torch.zeros_like(ent))


def point_instant_uncertainty(mu, cov, post_cov, umap, entropy, pred):
    """Scalar uncertainty derivations (single contour group)."""
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
        "cov_projection": projected_uncertainty_value(mu, cov),
        "umap_mean": umap.sum(dim=(-2, -1)) / mask_area,
    }
    if entropy is not None:
        instant_u["entropy_mean"] = entropy.sum(dim=(-2, -1)) / mask_area
    return point_u, instant_u


class AleatoricPredictor:
    """Per-view uncertainty propagation for the DSNT-AL contour task
    (Gaussian PSM sampler, one contour group, hard masks)."""

    def __init__(self, task, model, sampler: PosteriorShapeModelSampler,
                 t_a: Optional[int] = None, contour_groups=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.task = task
        self.model = model.to(self.device).eval()
        self.sampler = sampler
        self.t_a = t_a or task.t_a
        k = task.data_params.out_shape[0]
        groups = tuple(contour_groups) if contour_groups else ((0, k, 1),)
        if len(groups) != 1 or groups[0][:2] != (0, k):
            raise NotImplementedError("multi-structure contour groups are not ported yet")
        self.label = int(groups[0][2])

    @torch.inference_mode()
    def __call__(self, img, generator: Optional[torch.Generator] = None) -> Dict:
        """img (N, C, H, W) -> dict of device tensors for one view."""
        img = torch.as_tensor(np.asarray(img, np.float32)).to(self.device)
        h, w = img.shape[-2:]
        mu_te, cov_te = self.task.predict(self.model, img, generator=generator)
        samples = self.sampler.sample_batch(generator, mu_te, cov_te, n=self.t_a)
        mu, cov = fuse_epistemic_aleatoric(mu_te, cov_te)
        post_mu, post_cov = population_posterior(samples)

        occupancy = rasterize_batch(samples, h, w)  # (N, T_e, T_a, H, W) {0,1}
        umap = uncertainty_map(mu, cov, (h, w))
        pred = torch.where(occupancy.mean(dim=(1, 2)) > 0.5, self.label, 0).to(torch.int32)
        entropy = sample_entropy_map(occupancy)
        point_u, instant_u = point_instant_uncertainty(mu, cov, post_cov, umap,
                                                       entropy, pred)
        # Hard-mask populations hold small integer labels: ship them as uint8.
        pred_samples = (occupancy * self.label).to(torch.uint8)
        return {
            "mu": mu, "cov": cov, "mode": mu, "alpha": None,
            "post_mu": post_mu, "post_cov": post_cov,
            "contour_samples": samples, "pred_samples": pred_samples,
            "pred": pred, "uncertainty_map": umap, "entropy_map": entropy,
            "point_uncertainty": point_u, "instant_uncertainty": instant_u,
        }


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return None if tree is None else tree.detach().cpu().numpy()


def view_generator(seed: int, view_index: int) -> torch.Generator:
    """The CPU generator of one view, mixed from (seed, view index)."""
    state = np.random.SeedSequence([int(seed), int(view_index)]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def _run_predictor(predictor: AleatoricPredictor, views, seed: int) -> List[Dict]:
    """Run a predictor over a view list, one view at a time."""
    return [_to_numpy(predictor(v[Tags.img], view_generator(seed, vi)))
            for vi, v in enumerate(views)]


def check_predict_options(task_cfg: Dict):
    """Raise on the task options of the JAX predict path that the port does
    not have yet, instead of predicting without them."""
    for key in ("sequence_sampler", "soft_mask"):
        if task_cfg.get(key, False):
            raise NotImplementedError(f"task.{key}=true is not ported yet "
                                      "(ROADMAP.md Queue 1, item 4)")


def run_predict(task, model, data, cfg, split: str = "test",
                device: DeviceLike = None,
                metrics_out: Optional[Dict] = None) -> List[BatchResult]:
    """Predict every view of the split and assemble BatchResults, then run
    the results processors when `cfg` has `results_dir` or `save_path`.

    `model` is the task's backbone with its weights (task.build_model());
    `cfg` is a dict with optional "seed", "task": {"psm_path": ...} and the
    processors' "data": {"results_processors": [...]}. The processors'
    summary, `processor_errors` included, is merged into `metrics_out`."""
    device = resolve_device(device)
    task_cfg = cfg.get("task", {})
    check_predict_options(task_cfg)
    prior = get_or_fit_prior(data, task_cfg.get("psm_path"))
    sampler = PosteriorShapeModelSampler(prior, device=device)
    predictor = AleatoricPredictor(task, model, sampler,
                                   contour_groups=getattr(data, "contour_groups", None),
                                   device=device)
    views = list(data.predict_views(split))
    outs = _run_predictor(predictor, views, cfg.get("seed", 10))
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
