"""Per-view clinical metric dashboards: for every view, one composite figure
of the ED/ES images (contour samples, per-point confidence ellipses, the
entropy-map inset) with the Monte-Carlo distribution of each clinical
metric (Area at ED/ES, FAC, GLS) against its reference and predicted
markers; `{id}_reject.png` where a metric is rejected.

Counterpart of contouring_uncertainty_tpu/results/metric_figures.py, drawn
with the same matplotlib calls (figsize, gridspec, order of artists, file
names), so the same payload gives the same pixels.

`prepare_view_payload` reduces a view to a small numpy payload: its dense
sample splines come from one batched `ops/spline.py contour_spline` call
for both instants on the processor's device (the JAX package jits a vmap
of it, one call per instant). The call runs in f64 and its result is
rounded to f32: on samples with sub-pixel segments (an untrained head's)
the spline solve amplifies f32 rounding to ~7e-3 px, so an f32 solve on
the card and one on the CPU drew up to 1.1e-2 px apart; in f64 both stay
within f32 rounding of the exact spline. `render_view_payload` draws a payload with
numpy and matplotlib alone, so `render_dashboards` can fan the rendering
out over a fork process pool on large folds. The parent has initialised
CUDA by then: a forked child may not touch it, so the payloads hold numpy
arrays only and the children call no torch. A per-result timeout, then a
pool terminate and a serial re-render, guards against a wedged child.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from contouring_uncertainty_torch.device import DeviceLike, resolve_device
from contouring_uncertainty_torch.ops.spline import contour_spline
from contouring_uncertainty_torch.utils.plotting import confidence_ellipse

# Samples drawn on the image panels: the first min(2, T_e) x min(5, T_a).
_MAX_TE, _MAX_TA = 2, 5


def _bbox(map2d: np.ndarray, pad: int = 20):
    """Square crop window around the nonzero support of a 2-D map."""
    nz = map2d > 0
    if not nz.any():
        return 0, map2d.shape[0], 0, map2d.shape[1]
    rows = np.flatnonzero(nz.any(axis=1))
    cols = np.flatnonzero(nz.any(axis=0))
    cy = (rows[0] + rows[-1]) // 2
    cx = (cols[0] + cols[-1]) // 2
    s = max(rows[-1] - rows[0], cols[-1] - cols[0]) // 2 + pad
    h, w = map2d.shape
    return (max(cy - s, 0), min(cy + s + 1, h),
            max(cx - s, 0), min(cx + s + 1, w))


def _metric_axis(ax, info: Optional[Dict], label: str) -> bool:
    """One metric row: MC histogram, the mean with aleatoric (red) and
    aleatoric + epistemic (blue) error bars, the reference marker. Returns
    the reject flag, which tags the file name."""
    ax.set_ylabel(label, fontsize=12)
    ax.set_yticks([])
    if info is None:
        ax.set_axis_off()
        return False
    mc = np.asarray(info.get("mc", ()), float).ravel()
    mc = mc[np.isfinite(mc)]
    if mc.size:
        ax.hist(mc, bins=20, alpha=0.5, color="tab:gray")
    reject = bool(info.get("reject", False))
    mean, gt = info.get("mean"), info.get("gt")
    al = info.get("aleatoric_std", 0.0) or 0.0
    ep = info.get("epistemic_std", 0.0) or 0.0
    lo, hi = ax.get_ylim()
    y = lo + 0.75 * (hi - lo)
    fmt = "x" if reject else "o"
    if mean is not None and np.isfinite(mean):
        ax.errorbar([mean], [y], xerr=[al + ep], fmt=fmt, capsize=3, c="b",
                    elinewidth=2)
        ax.errorbar([mean], [y], xerr=[al], fmt=fmt, capsize=3, c="r",
                    elinewidth=2, markersize=9)
    if gt is not None and np.isfinite(gt):
        ax.scatter([gt], [y], c="k", s=80, zorder=3)
    return reject


def prepare_view_payload(res, instant_rows: Dict[str, Dict], view_rows: Dict[str, Dict],
                         mc: Dict[str, np.ndarray], device: DeviceLike = None) -> Dict:
    """Reduce one view to a small picklable payload of numpy arrays.

    The dense splines (256 points) of the first min(2, T_e) x min(5, T_a)
    contour samples of both instants come from one `contour_spline` call
    on `device`, in f64 (see the module docstring), returned as f32; the
    sample masks of the mask-contour variant are cut
    here too, so rendering never sees the (N, T_e, T_a, H, W) population.
    `instant_rows` and `view_rows` are the clinical processor's rows; `mc`
    maps 'Area_ED', 'Area_ES', 'FAC' and 'GLS' to their raw MC
    populations."""
    device = resolve_device(device)
    inst = res.instants or {"ED": 0, "ES": min(1, res.img.shape[0] - 1)}
    instants = {"ED": inst.get("ED", 0),
                "ES": inst.get("ES", min(1, res.img.shape[0] - 1))}

    dense = None
    if res.contour_samples is not None:
        cs = np.stack([np.asarray(res.contour_samples[i])[:_MAX_TE, :_MAX_TA]
                       for i in instants.values()])  # (2, te, ta, K, 2)
        flat = torch.as_tensor(cs.reshape(-1, *cs.shape[-2:]), dtype=torch.float32,
                               device=device).double()
        dense = contour_spline(flat, n=256).float().cpu().numpy().reshape(2, -1, 256, 2)

    panels = {}
    for j, (name, i) in enumerate(instants.items()):
        panel = {
            "img": np.asarray(res.img[i]).squeeze(),
            "entropy": (np.asarray(res.entropy_map[i])
                        if res.entropy_map is not None else None),
            "mu": np.asarray(res.mu[i]) if res.mu is not None else None,
            "cov": np.asarray(res.cov[i]) if res.cov is not None else None,
            "gt_contour": (np.asarray(res.contour[i])
                           if res.contour is not None else None),
            "dense_samples": dense[j] if dense is not None else None,
            "sample_masks": None,
        }
        if res.pred_samples is not None:
            ps = np.asarray(res.pred_samples[i])
            panel["sample_masks"] = (
                ps[:_MAX_TE, :_MAX_TA].reshape(-1, *ps.shape[-2:]) > 0.5
            ).astype(np.uint8)
        panels[name] = panel

    def row_info(rows, key, metric):
        row = rows.get(key)
        if row is None:
            return None
        info = {k[len(metric) + 1:]: v for k, v in row.items()
                if k.startswith(f"{metric}_")}
        return info or None

    metric_infos = {}
    for name in ("ED", "ES"):
        info = row_info(instant_rows, f"{res.id}/{name}", "Area")
        if info is not None:
            info["mc"] = np.asarray(mc.get(f"Area_{name}", ()), float)
        metric_infos[f"Area_{name}"] = info
    for metric in ("FAC", "GLS"):
        info = row_info(view_rows, res.id, metric)
        if info is not None:
            info["mc"] = np.asarray(mc.get(metric, ()), float)
        metric_infos[metric] = info

    return {"id": res.id, "panels": panels, "metric_infos": metric_infos}


def render_view_payload(payload: Dict, out_dir: Path, use_contour: bool = True,
                        dpi: int = 100) -> Path:
    """Render one prepared payload; returns the written path. numpy and
    matplotlib only, so a forked pool worker may call it."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig = plt.figure(figsize=(14, 9))
    spec = fig.add_gridspec(ncols=2, nrows=4, height_ratios=[1, 0.12, 0.12, 0.12])
    ax_img = {"ED": fig.add_subplot(spec[0, 0]),
              "ES": fig.add_subplot(spec[0, 1])}
    ax_area = {"ED": fig.add_subplot(spec[1, 0]),
               "ES": fig.add_subplot(spec[1, 1])}
    ax_fac = fig.add_subplot(spec[2, :])
    ax_gls = fig.add_subplot(spec[3, :])
    fig.subplots_adjust(left=0.05, right=0.99, top=0.96, bottom=0.04,
                        hspace=0.3, wspace=0.08)

    for name, panel in payload["panels"].items():
        ax = ax_img[name]
        ax.set_axis_off()
        ax.set_title(name)
        ax.imshow(panel["img"], cmap="gray")
        if panel["entropy"] is not None:
            ins = ax.inset_axes([0.7, 0.7, 0.3, 0.3])
            ins.set_axis_off()
            ent = panel["entropy"]
            r0, r1, c0, c1 = _bbox(ent)
            ins.imshow(ent[r0:r1, c0:c1])
        if use_contour and panel["mu"] is not None:
            mu = panel["mu"]
            ax.scatter(mu[:, 0], mu[:, 1], c="r", s=6)
            if panel["gt_contour"] is not None:
                gt_c = panel["gt_contour"]
                ax.scatter(gt_c[:, 0], gt_c[:, 1], c="b", s=6)
            if panel["cov"] is not None:
                for k in range(mu.shape[0]):
                    confidence_ellipse(mu[k, 0], mu[k, 1], panel["cov"][k],
                                       ax, n_std=2)
        if use_contour and panel["dense_samples"] is not None:
            for dense in panel["dense_samples"]:
                ax.plot(dense[:, 0], dense[:, 1], linewidth=1.2, alpha=0.85)
        elif not use_contour and panel["sample_masks"] is not None:
            # Mask-contour variant: the sampled masks' boundaries.
            for m in panel["sample_masks"]:
                ax.contour(m, levels=[0.5], linewidths=1.2)

    infos = payload["metric_infos"]
    reject = False
    for name in ("ED", "ES"):
        reject |= _metric_axis(ax_area[name], infos.get(f"Area_{name}"), "Area")
    reject |= _metric_axis(ax_fac, infos.get("FAC"), "FAC")
    reject |= _metric_axis(ax_gls, infos.get("GLS"), "GLS")

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = payload["id"].replace("/", "-")
    path = out_dir / (f"{stem}_reject.png" if reject else f"{stem}.png")
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path


def metric_plot(res, instant_rows: Dict[str, Dict], view_rows: Dict[str, Dict],
                mc: Dict[str, np.ndarray], out_dir: Path, use_contour: bool = True,
                dpi: int = 100, device: DeviceLike = None) -> Path:
    """Prepare and render one view's dashboard (the arguments of
    `prepare_view_payload` and `render_view_payload`)."""
    payload = prepare_view_payload(res, instant_rows, view_rows, mc, device)
    return render_view_payload(payload, out_dir, use_contour, dpi)


def _render_both(args) -> List[str]:
    """Pool task: render a payload's spline- and mask-contour dashboards."""
    payload, out_root = args
    out_root = Path(out_root)
    return [
        str(render_view_payload(payload, out_root / "metric_figures",
                                use_contour=True)),
        str(render_view_payload(payload, out_root / "metric_figures2",
                                use_contour=False)),
    ]


def render_dashboards(payloads: List[Dict], out_root: Path,
                      parallel_threshold: int = 16,
                      max_workers: int = 8) -> None:
    """Render every view's two dashboards into `out_root`/metric_figures
    (spline contours) and `out_root`/metric_figures2 (mask contours).

    From `parallel_threshold` views on, over a fork process pool (spawn
    would re-run an unguarded caller's script in every worker); fewer
    views render serially, as pool start-up would dominate. Any pool
    failure, a worker that returns no figure for 120 s included, falls
    back to rendering everything serially (same file names), after the
    failure is printed to stderr. The JAX package's pool initialiser pins
    its workers' JAX to the CPU; the workers here call no torch and need
    none."""
    import os
    import sys

    tasks = [(p, str(out_root)) for p in payloads]
    if len(payloads) >= parallel_threshold:
        import multiprocessing as mp

        try:
            ctx = mp.get_context("fork")  # raises on non-POSIX -> serial
            with ctx.Pool(min(max_workers, os.cpu_count() or 1)) as pool:
                # chunksize 1: only then is the iterator one with
                # next(timeout) (the JAX package's chunksize=2 gives a plain
                # generator, so its pool always falls back to serial).
                it = pool.imap_unordered(_render_both, tasks)
                for _ in range(len(tasks)):
                    it.next(timeout=120)
            return
        except Exception as exc:  # render serially, and say why
            print(f"render_dashboards: the fork pool failed ({type(exc).__name__}: {exc}); "
                  f"rendering {len(tasks)} views serially", file=sys.stderr)
    for task in tasks:
        _render_both(task)
