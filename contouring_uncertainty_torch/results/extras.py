"""Small result processors: skewness diagnostics, sigma statistics, sample
plots, and the per-view HDF5 prediction writer.

Counterpart of contouring_uncertainty_tpu/results/extras.py, in numpy and
scipy on the host as there. `skewness` draws its scatter after its numbers
(results/__init__.py `draw_figures`); `plotting` draws its panels the
same way; `prediction_writer` imports h5py first, as the JAX package does,
so without it the processor fails and writes nothing.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

from contouring_uncertainty_torch.results import draw_figures, register


@register("skewness")
def skewness(results: List, out_dir: Path) -> dict:
    """Per-landmark error clouds and the average alpha: `skewness.npy`
    ({"errors": (frames, K, 2) contour - mu, "average_skew": (frames, K, 2)
    alpha}), the mean over landmarks of the errors' sample skewness in x
    and y and the mean alpha norm, then `skewness_error.png`: each
    landmark's error cloud around the first view's first mu."""
    from scipy.stats import skew as sp_skew

    point_errors, alphas = [], []
    for res in results:
        if res.mu is None or res.contour is None:
            continue
        for i in range(res.img.shape[0]):
            point_errors.append(res.contour[i] - res.mu[i])
            if res.alpha is not None:
                alphas.append(res.alpha[i])
    if not point_errors:
        return {}
    point_errors = np.stack(point_errors)
    np.save(out_dir / "skewness.npy",
            {"errors": point_errors,
             "average_skew": np.stack(alphas) if alphas else np.zeros(0)},
            allow_pickle=True)
    out = {
        "error_skew_x": float(np.mean(sp_skew(point_errors[..., 0], axis=0))),
        "error_skew_y": float(np.mean(sp_skew(point_errors[..., 1], axis=0))),
    }
    if alphas:
        out["mean_alpha_norm"] = float(np.linalg.norm(np.stack(alphas), axis=-1).mean())
    return draw_figures(out, [lambda: _plot_skewness(results, point_errors, out_dir)])


def _plot_skewness(results: List, point_errors: np.ndarray, out_dir: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    ref_shape = results[0].mu[0]
    f, ax = plt.subplots()
    h = results[0].img.shape[-2]
    ax.set_xlim([0, h])
    ax.set_ylim([h, 0])
    for i in range(point_errors.shape[1]):
        ax.scatter(ref_shape[i, 0] + point_errors[:, i, 0],
                   ref_shape[i, 1] + point_errors[:, i, 1], alpha=0.4, s=4)
    ax.scatter(ref_shape[:, 0], ref_shape[:, 1], c="k", s=8)
    plt.savefig(out_dir / "skewness_error.png", dpi=80)
    plt.close()


@register("sigma_stats")
def sigma_stats(results: List, out_dir: Path) -> dict:
    """Average covariance vs average distance per landmark."""
    sigmas, dists = [], []
    for res in results:
        if res.mu is None or res.contour is None or res.cov is None:
            continue
        dists.append(np.linalg.norm(res.mu - res.contour, axis=-1))
        sigmas.append(res.cov)
    if not sigmas:
        return {}
    sigmas = np.concatenate(sigmas).mean(0)  # (K, 2, 2)
    dists = np.concatenate(dists).mean(0)  # (K,)
    det = np.maximum(np.linalg.det(sigmas), 0) ** 0.25
    np.save(out_dir / "sigma_stats.npy", {"avg_cov": sigmas, "avg_dist": dists},
            allow_pickle=True)
    corr = float(np.corrcoef(det, dists)[0, 1]) if len(det) > 2 else np.nan
    return {"avg_sigma_det": float(det.mean()), "avg_distance": float(dists.mean()),
            "corr_det_distance": corr}


@register("plotting")
def sample_plots(results: List, out_dir: Path, max_views: int = 4) -> dict:
    """Qualitative panels of the first `max_views` views, one row per frame
    (image with mu and the reference contour, prediction, reference,
    uncertainty map): figures/{id}.png."""
    return draw_figures({}, [lambda: _plot_samples(results[:max_views], out_dir / "figures")])


def _plot_samples(results: List, plot_dir: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    plot_dir.mkdir(parents=True, exist_ok=True)
    for res in results:
        n = res.img.shape[0]
        f, axes = plt.subplots(n, 4, squeeze=False, figsize=(12, 3 * n))
        for i in range(n):
            img = res.img[i].squeeze()
            axes[i][0].imshow(img, cmap="gray")
            axes[i][0].set_title("image")
            if res.mu is not None:
                axes[i][0].scatter(res.mu[i, :, 0], res.mu[i, :, 1], s=6, c="r")
            if res.contour is not None:
                axes[i][0].scatter(res.contour[i, :, 0], res.contour[i, :, 1], s=6, c="b")
            axes[i][1].imshow(res.pred[i])
            axes[i][1].set_title("pred")
            if res.gt is not None:
                axes[i][2].imshow(res.gt[i])
                axes[i][2].set_title("gt")
            axes[i][3].imshow(res.uncertainty_map[i])
            axes[i][3].set_title("uncertainty")
            for ax in axes[i]:
                ax.set_axis_off()
        plt.tight_layout()
        plt.savefig(plot_dir / f"{res.id.replace('/', '_')}.png", dpi=70)
        plt.close()


@register("prediction_writer")
def prediction_writer(results: List, out_dir: Path) -> dict:
    """Every view's predictions in one HDF5 file, predictions.h5: a group
    per view id holding `pred`, `uncertainty_map` and `entropy_map`
    (gzip), `mu`, `mode`, `cov`, `alpha`, `post_mu`, `post_cov` and
    `contour` where the view has them, and the instants and voxel spacing
    as attributes."""
    import h5py

    path = out_dir / "predictions.h5"
    with h5py.File(path, "w") as f:
        for res in results:
            g = f.create_group(res.id)
            g.create_dataset("pred", data=res.pred, compression="gzip")
            g.create_dataset("uncertainty_map", data=res.uncertainty_map, compression="gzip")
            if res.entropy_map is not None:
                g.create_dataset("entropy_map", data=res.entropy_map, compression="gzip")
            for name in ("mu", "mode", "cov", "alpha", "post_mu", "post_cov", "contour"):
                value = getattr(res, name)
                if value is not None:
                    g.create_dataset(name, data=value)
            if res.instants:
                for key, value in res.instants.items():
                    g.attrs[key] = value
            if res.voxelspacing is not None:
                g.attrs["voxelspacing"] = np.asarray(res.voxelspacing)
    return {"written_views": len(results)}
