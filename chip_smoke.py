#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (contouring_uncertainty_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py              # the smoke run
    python3 chip_smoke.py --profile    # plus the full torch.profiler table and
                                       # a Chrome trace, written to chiprun_out/

Phases (any failure raises, so the script exits non-zero and prints no
result line):

1. card check: CUDA present; the card's name and power limit; TF32 off for
   matmuls and cuDNN convolutions;
2. build: nvcc for the two CUDA sources (csrc/min_k_crossings.cu,
   csrc/dsnt_moments.cu, in parallel) from the sources in this checkout
   into contouring_uncertainty_torch/_build/, with ptxas's register report;
3. DSNT moment kernels against their plain version in f64: the row kernel
   (K2; 420 heatmaps, and 21 split into bands, one cluster each) and the
   column kernel (K1; 420 columns, 21 columns, and 420 columns of a
   512-wide buffer), random and sharp off-centre blob heatmaps, bf16, f16
   and f32, at 256^2 and 64^2: mu <= 1e-4 px, sigma relative error <= 1e-3;
4. crossing-selection kernel (CUDA, K3) against its plain version on the
   zigzag contours of the JAX package's parity check and on the edge cases
   of ops/rasterize.py `selection_edge_cases` (tied crossings, horizontal
   edges, vertices outside the image, rows with more crossings than a
   bucket holds): bitwise-equal crossings, 0 mismatched fill pixels; the
   rows that took the overflow path are counted and must not be 0; on
   polygons with NaN and infinite vertices, equal to the plain selection
   with NaN candidates dropped (the one place where the two differ);
5. the main path: `run_predict` on synthetic CAMUS-like views with the
   flagship TMI serving configuration (8-stage UNet at full width, bf16,
   MC dropout T_e=10 x PSM T_a=25, 256^2, K=21) and seed-initialised
   weights; launch counters reset just before and read just after; outputs
   finite with the JAX package's shapes; steady-state views/s; the device's
   busy time per view from a profiled pass, and the top kernels;
6. the crossing selection again on one view's 500 sampled contours;
7. the GPU path against the CPU path (plain versions) on a small input;
8. kernel timings beside their bounds and plain versions at the main
   path's shapes; K2's band splits at the row counts of T_e=1, 5 and 10;
   K1's launch at the serving shape and K1 at 21 and 42 columns;
   the kernels JSON line (K1, K2, K3), the card line and the final
   {"ok": true, ...} line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and f32 outside
# the tensor cores. Bounds below are computed from this run's inputs.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

DSNT_BARS = {"mu_px": 1e-4, "sigma_rel": 1e-3}

MAIN_CFG = dict(t_e=10, t_a=25, size=256, k=21, n_patients=8, seed=0)
STEADY_PASSES = 5  # timed passes over the test views after the first


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms: `iters` calls captured in one CUDA
    graph and replayed between two CUDA events, so the host's launch cost
    (Python, ctypes) does not pad the kernel's time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dsnt_inputs(n: int, size: int, rng: np.random.Generator) -> dict:
    """n random-logit heatmaps and n sharp off-centre Gaussian blobs
    (2-8 px spreads, the regime of a trained DSNT head), (n, size^2) f32."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    cx = rng.uniform(0.15 * size, 0.85 * size, n)[:, None, None]
    cy = rng.uniform(0.15 * size, 0.85 * size, n)[:, None, None]
    s = rng.uniform(2.0, 8.0, n)[:, None, None]
    blobs = -((xs - cx) ** 2 + (ys - cy) ** 2) / (2.0 * s * s)
    return {"random": rng.normal(size=(n, size * size)).astype(np.float32),
            "blob": blobs.reshape(n, -1).astype(np.float32)}


def check_dsnt(size: int, n: int = 420) -> dict:
    """Both moment kernels against f64 on n random and n blob heatmaps of
    size^2: K2 on the row layout (all n heatmaps, one block each, and the
    first 21, split into bands), K1 on the column layout (all n, the first
    21, and n columns of a 512-wide buffer)."""
    import torch

    from contouring_uncertainty_torch.ops import dsnt_kernel
    from contouring_uncertainty_torch.ops.dsnt import raw6_to_pixel_gaussians

    worst = {"mu_px": 0.0, "sigma_rel": 0.0}
    for name, x in dsnt_inputs(n, size, np.random.default_rng(7)).items():
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            xt = torch.as_tensor(x, device="cuda").to(dtype)
            ref = dsnt_kernel.raw_moments_plain(xt.double(), size, size)
            mu_r, sig_r = raw6_to_pixel_gaussians(ref[:, :6], size, size)
            scale = (sig_r[:, 0, 0] + sig_r[:, 1, 1])[:, None, None] / 2.0
            few = xt[:21]
            bands = dsnt_kernel.row_bands(21, size, size, xt.element_size(), n_sm())
            wide = torch.full((size * size, 512), float("nan"), device="cuda", dtype=dtype)
            wide[:, :n] = xt.t()
            layouts = {
                "rows (K2)": (dsnt_kernel.raw_moments_cuda(xt, size, size), slice(None)),
                f"rows, 21 in {bands} bands (K2)":
                    (dsnt_kernel.raw_moments_cuda(few, size, size), slice(0, 21)),
                f"cols, {n} (K1)": (dsnt_kernel.dsnt_raw_moments_cols(xt.t().contiguous(), size,
                                                                      size), slice(None)),
                "cols, 21 (K1)": (dsnt_kernel.dsnt_raw_moments_cols(few.t().contiguous(), size,
                                                                    size), slice(0, 21)),
                f"cols, {n} of 512 (K1)": (dsnt_kernel.dsnt_raw_moments_cols(wide[:, :n], size,
                                                                             size), slice(None)),
            }
            for layout, (raw, sel) in layouts.items():
                mu_k, sig_k = raw6_to_pixel_gaussians(raw[:, :6].double(), size, size)
                mu_err = (mu_k - mu_r[sel]).abs().max().item()
                sig_err = ((sig_k - sig_r[sel]).abs() / scale[sel]).max().item()
                print(f"  dsnt {size}^2 {name:6s} {str(dtype):14s} {layout}: "
                      f"mu err {mu_err:.3e} px, sigma rel err {sig_err:.3e}")
                worst["mu_px"] = max(worst["mu_px"], mu_err)
                worst["sigma_rel"] = max(worst["sigma_rel"], sig_err)
    torch.cuda.synchronize()
    if not (worst["mu_px"] <= DSNT_BARS["mu_px"] and worst["sigma_rel"] <= DSNT_BARS["sigma_rel"]):
        raise AssertionError(f"DSNT kernels outside their bars {DSNT_BARS}: {worst}")
    return worst


def n_sm() -> int:
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def check_selection(dense, height: int, width: int, label: str) -> int:
    """Kernel vs plain crossings (bitwise) and fills (pixel count) on the
    card. Returns the number of rows that took the kernel's overflow path."""
    import torch

    from contouring_uncertainty_torch.ops import select_kernel
    from contouring_uncertainty_torch.ops.rasterize import fill_from_crossings

    overflow = torch.zeros(1, dtype=torch.int32, device="cuda")
    xs_k = select_kernel.min_k_crossings_kernel(dense, height, overflow_rows=overflow)
    xs_p = select_kernel.min_k_crossings_plain(dense, height)
    torch.cuda.synchronize()
    unequal = int((xs_k != xs_p).sum().item())
    fill_k = fill_from_crossings(xs_k, dense, width)
    fill_p = fill_from_crossings(xs_p, dense, width)
    mismatch = int((fill_k != fill_p).sum().item())
    n_overflow = int(overflow.item())
    print(f"  selection {label}: {dense.shape[0]} masks, crossings differing "
          f"{unequal}, fill pixels differing {mismatch}, filled px "
          f"{int(fill_k.sum().item())}, rows on the overflow path {n_overflow}")
    if unequal or mismatch:
        raise AssertionError(f"crossing selection differs from its plain version ({label})")
    return n_overflow


def check_non_finite() -> None:
    """K3 drops a NaN abscissa, where the plain version keeps it (torch.topk
    ranks NaN first). On polygons with a NaN or infinite vertex coordinate
    the kernel must equal the plain selection over the candidates with NaN
    set to +inf, bitwise."""
    import torch

    from contouring_uncertainty_torch.ops import select_kernel

    height = 16
    angle = np.linspace(0.0, 2.0 * np.pi, 32, endpoint=False)
    circle = np.stack([8.0 + 5.5 * np.cos(angle), 8.0 + 5.5 * np.sin(angle)], -1)
    polys = np.repeat(circle[None].astype(np.float32), 4, axis=0)
    polys[0, 3, 1] = np.nan
    polys[1, 9, 0] = np.nan
    polys[2, 20, 1] = np.inf
    polys[3, 27, 0] = -np.inf
    dense = torch.as_tensor(polys, device="cuda")
    cand = select_kernel.crossing_candidates(dense, height)
    ref = -torch.topk(-torch.where(cand.isnan(), float("inf"), cand),
                      select_kernel.K_CROSSINGS, dim=-1).values
    got = select_kernel.min_k_crossings_kernel(dense, height)
    plain_nan = int(select_kernel.min_k_crossings_plain(dense, height).isnan().any(-1).sum())
    unequal = int((got != ref).sum().item())
    print(f"  selection non-finite vertices: crossings differing from the NaN-dropping "
          f"selection {unequal}; rows where the plain version keeps NaN {plain_nan}")
    if unequal:
        raise AssertionError("crossing selection on non-finite vertices differs")


def main_path(profile_dir=None) -> dict:
    """run_predict on the flagship serving configuration."""
    import torch

    from contouring_uncertainty_torch.data.synthetic import SyntheticContourData
    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel
    from contouring_uncertainty_torch.predict import run_predict
    from contouring_uncertainty_torch.tasks import DSNTAleatoric

    c = MAIN_CFG
    t0 = time.perf_counter()
    data = SyntheticContourData(n_patients=c["n_patients"], k=c["k"], size=c["size"],
                                seed=c["seed"])
    task = DSNTAleatoric(
        data_params=data.data_params, t_e=c["t_e"], t_a=c["t_a"], covar=True,
        model_kwargs=dict(drop_block=True, dtype="bfloat16", head_dtype="bfloat16"))
    model = task.build_model(device="cuda",
                             generator=torch.Generator().manual_seed(c["seed"]))
    cfg = {"seed": c["seed"]}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  set-up {time.perf_counter() - t0:.1f} s: {n_params} UNet parameters, "
          f"{len(list(data.predict_views('test')))} test views")

    dsnt_kernel.row_launches = dsnt_kernel.col_launches = 0
    select_kernel.launches = 0
    t0 = time.perf_counter()
    results = run_predict(task, model, data, cfg, split="test")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"K1 dsnt (column layout)": dsnt_kernel.col_launches,
                "K2 dsnt (row layout)": dsnt_kernel.row_launches,
                "K3 select": select_kernel.launches}
    n_views = len(results)
    print(f"  main path: {n_views} views in {first_s:.2f} s (first run, warm-up "
          f"included); kernel launches {launches}")
    for name in ("K2 dsnt (row layout)", "K3 select"):
        if launches[name] < n_views:
            raise AssertionError(f"the main path launched {name} {launches[name]} times "
                                 f"in {n_views} views")

    n, t_e, t_a, k, s = 2, c["t_e"], c["t_a"], c["k"], c["size"]
    shapes = {"mu": (n, k, 2), "cov": (n, k, 2, 2), "post_mu": (n, k, 2),
              "post_cov": (n, k, 2, 2), "contour_samples": (n, t_e, t_a, k, 2),
              "pred_samples": (n, t_e, t_a, s, s), "pred": (n, s, s),
              "uncertainty_map": (n, s, s), "entropy_map": (n, s, s)}
    for res in results:
        for key, shape in shapes.items():
            value = getattr(res, key)
            if value.shape != shape:
                raise AssertionError(f"{key} shape {value.shape} != {shape}")
            if not np.isfinite(value.astype(np.float64)).all():
                raise AssertionError(f"{key} has non-finite values")
        for group in (res.point_uncertainty, res.instant_uncertainty):
            for key, value in group.items():
                if not np.isfinite(value).all():
                    raise AssertionError(f"{key} has non-finite values")
        if res.pred_samples.max() != 1 or res.uncertainty_map.max() <= 0:
            raise AssertionError("no sample mask or uncertainty map was painted")

    # Steady state: more passes over the same views, all kernels built.
    pass_s = []
    for _ in range(STEADY_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_predict(task, model, data, cfg, split="test")
        torch.cuda.synchronize()
        pass_s.append(time.perf_counter() - t0)
    ms_per_view = sorted(1e3 * t / n_views for t in pass_s)
    kernel_ms, copy_ms, table = profile_run(
        lambda: run_predict(task, model, data, cfg, split="test"), profile_dir)
    median = ms_per_view[len(ms_per_view) // 2]
    return {"views": n_views, "launches": launches, "first_s": first_s,
            "views_per_s": 1e3 / median, "ms_per_view": median,
            "ms_per_view_range": (ms_per_view[0], ms_per_view[-1]),
            "kernel_ms_per_view": kernel_ms / n_views, "copy_ms_per_view": copy_ms / n_views,
            "profile": table,
            "results": results, "task": task, "model": model, "data": data}


def profile_run(fn, out_dir=None):
    """torch.profiler over one more steady-state pass. Returns the summed
    device time (ms) of the kernels and of the copies (the device-side
    events only: each aten op's own "self CUDA" time repeats its kernels'),
    and the top rows by device time. With `out_dir`, the full table and a
    Chrome trace are written there."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    copy_ms = sum(e.self_device_time_total for e in device
                  if e.key.startswith(("Memcpy", "Memset"))) / 1e3
    kernel_ms = sum(e.self_device_time_total for e in device) / 1e3 - copy_ms
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "profile_run.txt").write_text(
            events.table(sort_by="self_device_time_total", row_limit=80))
        prof.export_chrome_trace(str(out_dir / "profile_run.json"))
    return kernel_ms, copy_ms, events.table(sort_by="self_device_time_total", row_limit=12)


def small_reference_check():
    """The GPU path (kernels) against the CPU path (plain versions) on one
    small view: same weights, same CPU-generator draws."""
    import torch

    from contouring_uncertainty_torch.data.config import DataParams
    from contouring_uncertainty_torch.data.synthetic import make_arrays
    from contouring_uncertainty_torch.ops.rasterize import rasterize_batch
    from contouring_uncertainty_torch.predict import AleatoricPredictor, view_generator
    from contouring_uncertainty_torch.sampler import PosteriorShapeModelSampler, fit_shape_prior
    from contouring_uncertainty_torch.tasks import DSNTAleatoric

    imgs, _, contours = make_arrays(12, size=64, seed=1)
    task = DSNTAleatoric(
        data_params=DataParams(in_shape=(1, 64, 64), out_shape=(21, 2)), t_e=2, t_a=8,
        model_kwargs=dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3,
                          drop_block=True))
    prior = fit_shape_prior(contours)
    outs = {}
    for device in ("cpu", "cuda"):
        model = task.build_model(device=device, generator=torch.Generator().manual_seed(3))
        predictor = AleatoricPredictor(
            task, model, PosteriorShapeModelSampler(prior, device=device), device=device)
        outs[device] = {k: v for k, v in predictor(imgs[:2], view_generator(5, 0)).items()
                        if isinstance(v, torch.Tensor)}
    cpu, gpu = outs["cpu"], {k: v.cpu() for k, v in outs["cuda"].items()}
    mu_err = (gpu["mu"] - cpu["mu"]).abs().max().item()
    cov_err = ((gpu["cov"] - cpu["cov"]).abs().max() / cpu["cov"].abs().max()).item()
    sample_dev = (gpu["contour_samples"] - cpu["contour_samples"]).abs().median().item()
    pop_diff = (gpu["pred_samples"] != cpu["pred_samples"]).float().mean().item()
    # The same (CPU) sample contours rasterized through the kernel path and
    # through the plain path isolate the fill from the sampler's rounding.
    samples = cpu["contour_samples"]
    fill_gpu = rasterize_batch(samples.cuda(), 64, 64).cpu()
    fill_diff = (fill_gpu != rasterize_batch(samples, 64, 64)).float().mean().item()
    print(f"  GPU vs CPU (64^2, 4-stage f32, T_e=2, T_a=8): mu {mu_err:.2e} px, "
          f"cov rel {cov_err:.2e}, median sample shift {sample_dev:.2e} px, "
          f"sample-mask pixels differing {pop_diff:.2e}; same samples filled on "
          f"both: pixels differing {fill_diff:.2e}")
    # mu and cov: f32 convolutions reduce in another order on the card (TF32
    # off), ~1e-5 px. The PSM posterior of an untrained model is conditioned
    # at ~1e8, so f32 rounding alone moves its samples by up to ~2 px and
    # flips ~0.5% of sample-mask pixels (measured on the CPU, f32 vs f64
    # with the same normals): the population is held by its median shift and
    # that budget, the fill itself exactly.
    if (mu_err > 1e-3 or cov_err > 1e-3 or sample_dev > 1e-2 or pop_diff > 2e-2
            or fill_diff > 1e-4):
        raise AssertionError("GPU path disagrees with the CPU path")


def kernel_timings(main: dict) -> list:
    import torch

    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel
    from contouring_uncertainty_torch.ops.spline import contour_spline

    c = MAIN_CFG
    n_views = main["views"]
    launches = main["launches"]
    model = main["model"]
    view = next(iter(main["data"].predict_views("test")))
    img = torch.as_tensor(view["img"], device="cuda")
    size = c["size"]

    # DSNT kernels at the main path's shape: the (T_e*N, K, H, W) bf16 head
    # output of one view (420 heatmaps of 256^2), row layout for K2 and its
    # (HW, 420) transpose for K1.
    with torch.inference_mode():
        logits = model(img.repeat(c["t_e"], 1, 1, 1), deterministic=False,
                       generator=torch.Generator().manual_seed(1))["out"]
    rows_in = logits.reshape(-1, size * size)
    rows, hw = rows_in.shape
    cols_in = rows_in.t().contiguous()
    raw_ref = dsnt_kernel.raw_moments_plain(rows_in.double(), size, size)
    raw_k2 = dsnt_kernel.dsnt_raw_moments(rows_in, size, size)
    raw_k1 = dsnt_kernel.dsnt_raw_moments_cols(cols_in, size, size)
    k2_ms = cuda_ms(lambda: dsnt_kernel.raw_moments_cuda(rows_in, size, size))
    k1_ms = cuda_ms(lambda: dsnt_kernel.raw_moments_cols_cuda(cols_in, size, size))
    d_plain = cuda_ms(lambda: dsnt_kernel.raw_moments_plain(rows_in, size, size))
    d_plain_cols = cuda_ms(lambda: dsnt_kernel.raw_moments_plain(cols_in.t(), size, size))
    # K2's band split at the heatmap counts of the task's configurations:
    # T_e=1 (its default, deterministic) at N=1 and N=2 frames, T_e=5 and the
    # main path's T_e=10 at N=2; each split against one block per heatmap.
    band_ms = {}
    for r in (c["k"], 2 * c["k"], 10 * c["k"], rows):
        part = rows_in[:r]
        chosen = dsnt_kernel.row_bands(r, size, size, part.element_size(), n_sm())
        times = {b: cuda_ms(lambda: dsnt_kernel.raw_moments_cuda(part, size, size, bands=b))
                 for b in (1, 2, 4, 8)}
        band_ms[r] = {"chosen": chosen, "ms": times}
        print(f"    K2 at {r} heatmaps, ms by bands: "
              f"{', '.join(f'{b}: {t:.4f}' for b, t in times.items())}; row_bands {chosen}")
    # K1's launch at the main path's shape, then K1 at the column counts of
    # T_e=1 (21 heatmaps, one frame; 42, two).
    lay = dsnt_kernel.cols_layout(hw, rows, size, size, cols_in.element_size(),
                                  cols_in.stride(), cols_in.data_ptr(), n_sm())
    print(f"    K1 at {rows} columns: {lay}")
    few_ms = {}
    for r in (c["k"], 2 * c["k"]):
        few = cols_in[:, :r].contiguous()
        few_ms[r] = {"ms": cuda_ms(lambda: dsnt_kernel.raw_moments_cols_cuda(few, size, size)),
                     "bound_ms": (hw * r * few.element_size() + r * 32) / HBM_BYTES_PER_S * 1e3}
        print(f"    K1 at {r} columns: {few_ms[r]['ms']:.4f} ms "
              f"(bound {few_ms[r]['bound_ms']:.4f} ms by bytes)")
    d_bytes = rows * hw * rows_in.element_size() + rows * 8 * 4
    # max, subtract, exp, 8 multiplies and 8 adds per pixel
    d_ops = rows * hw * 19
    d_bound = {"bytes": d_bytes / HBM_BYTES_PER_S * 1e3, "operations": d_ops / F32_OPS_PER_S * 1e3}

    # Crossing selection at the main path's shape: one view's 500 sampled
    # contours, splined to 1024 vertices, 256 rows.
    samples = torch.as_tensor(main["results"][0].contour_samples, device="cuda")
    dense = contour_spline(samples.reshape(-1, c["k"], 2), n=1024).contiguous()
    m, e, _ = dense.shape
    k3_ms = cuda_ms(lambda: select_kernel.min_k_crossings_kernel(dense, size))
    s_plain = cuda_ms(lambda: select_kernel.min_k_crossings_plain(dense, size), iters=5)
    neg_cand = -select_kernel.crossing_candidates(dense, size)
    s_lib = cuda_ms(lambda: torch.topk(neg_cand, 16, dim=-1), iters=5)
    n_cross = int(torch.isfinite(neg_cand).sum().item())
    del neg_cand
    xs_k = select_kernel.min_k_crossings_kernel(dense, size)
    xs_p = select_kernel.min_k_crossings_plain(dense, size)
    s_err = torch.where(xs_k == xs_p, 0.0, (xs_k - xs_p).abs()).max().item()
    # What the function needs, whatever the algorithm: each edge's row range
    # (a min, a max and two ceilings) and, per actual crossing, a subtract,
    # divide, subtract, multiply, add and compare; the vertices read once and
    # the crossings written once.
    s_ops = 4 * m * e + 6 * n_cross
    s_bytes = m * e * 2 * 4 + m * size * 16 * 4
    s_bound = {"bytes": s_bytes / HBM_BYTES_PER_S * 1e3, "operations": s_ops / F32_OPS_PER_S * 1e3}

    def bound(b):
        return {"bound_ms": max(b.values()), "bound_by": max(b, key=b.get)}

    return [
        {"name": "K1 dsnt_moments_cols (online-softmax DSNT moments, column layout)",
         "route": "cuda", "source": "contouring_uncertainty_torch/csrc/dsnt_moments.cu",
         "replaces": "contouring_uncertainty_tpu/ops/pallas_dsnt.py:198",
         "launches": launches["K1 dsnt (column layout)"],
         "launches_per_view": launches["K1 dsnt (column layout)"] / n_views,
         "shape": [hw, rows], "dtype": str(rows_in.dtype),
         "max_abs_err": (raw_k1.double() - raw_ref).abs().max().item(),
         "ms": k1_ms, "layout": lay._asdict(), "few_columns": few_ms,
         "plain_ms": d_plain_cols, **bound(d_bound), "library_ms": None},
        {"name": "K2 dsnt_moments (online-softmax DSNT moments, row layout)",
         "route": "cuda", "source": "contouring_uncertainty_torch/csrc/dsnt_moments.cu",
         "replaces": "contouring_uncertainty_tpu/ops/pallas_dsnt.py:105",
         "launches": launches["K2 dsnt (row layout)"],
         "launches_per_view": launches["K2 dsnt (row layout)"] / n_views,
         "shape": [rows, hw], "dtype": str(rows_in.dtype),
         "max_abs_err": (raw_k2.double() - raw_ref).abs().max().item(),
         "ms": k2_ms, "bands_ms": band_ms,
         "plain_ms": d_plain, **bound(d_bound), "library_ms": None},
        {"name": "K3 min_k_crossings (exact min-16 scanline crossing selection)",
         "route": "cuda", "source": "contouring_uncertainty_torch/csrc/min_k_crossings.cu",
         "replaces": "contouring_uncertainty_tpu/ops/pallas_select.py:89",
         "launches": launches["K3 select"],
         "launches_per_view": launches["K3 select"] / n_views,
         "shape": [m, e, size], "crossings": n_cross,
         "max_abs_err": s_err,
         "ms": k3_ms,
         "plain_ms": s_plain, **bound(s_bound),
         "library_ms": s_lib, "library_call": "torch.topk over the (M, H, E) candidates"},
    ]


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; one CUDA GPU is required",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card} ({torch.cuda.device_count()} visible); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("    torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    from contouring_uncertainty_torch import build
    from contouring_uncertainty_torch.ops import dsnt_kernel
    from contouring_uncertainty_torch.ops.rasterize import (
        EDGE_CASE_SIZE,
        selection_edge_cases,
        zigzag_contours,
    )
    from contouring_uncertainty_torch.ops.spline import contour_spline

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[2] build: nvcc {time.perf_counter() - t0:.1f} s "
          f"({', '.join(p.name for p in libs)})")
    for name, log in build.BUILD_LOGS.items():
        print("    " + "\n    ".join(line for line in log.splitlines() if "ptxas info" in line
                                    and ("registers" in line or "spill" in line)))

    print("[3] DSNT moment kernels vs plain f64 (420 heatmaps of 256^2, then of 64^2)")
    worst = [check_dsnt(256), check_dsnt(64)]
    dsnt_worst = {k: max(w[k] for w in worst) for k in worst[0]}

    print("[4] crossing selection vs plain: zigzag contours (64, 256^2, n=1024), "
          f"edge cases ({EDGE_CASE_SIZE}^2, 256 vertices)")
    zz = torch.as_tensor(zigzag_contours(64, seed=0), device="cuda")
    check_selection(contour_spline(zz, n=1024).contiguous(), 256, 256, "zigzag")
    n_overflow = sum(
        check_selection(torch.as_tensor(arr, device="cuda"), EDGE_CASE_SIZE, EDGE_CASE_SIZE,
                        f"edge case {name}")
        for name, arr in selection_edge_cases().items())
    print(f"    rows on the overflow path over the edge cases: {n_overflow}")
    if n_overflow == 0:
        raise AssertionError("no edge case exercised the selection's overflow path")
    check_non_finite()

    profile_dir = Path("chiprun_out") if "--profile" in argv else None
    print("[5] main path: run_predict, flagship TMI serving configuration")
    main_res = main_path(profile_dir)
    kernel_ms, copy_ms = main_res["kernel_ms_per_view"], main_res["copy_ms_per_view"]
    busy = (kernel_ms + copy_ms) / main_res["ms_per_view"]
    lo, hi = main_res["ms_per_view_range"]
    print(f"    steady state: {main_res['views_per_s']:.2f} views/s, median "
          f"{main_res['ms_per_view']:.1f} ms/view over {STEADY_PASSES} passes of "
          f"{main_res['views']} views (range {lo:.1f}-{hi:.1f}) on {card}")
    print(f"    device busy per view (profiled pass): kernels {kernel_ms:.2f} ms + copies "
          f"{copy_ms:.2f} ms = {busy:.1%} of the steady-state view time; idle share "
          f"{1 - busy:.1%}")
    print(main_res["profile"])

    print("[6] crossing selection vs plain: one view's sampled contours")
    samples = torch.as_tensor(main_res["results"][0].contour_samples, device="cuda")
    check_selection(contour_spline(samples.reshape(-1, MAIN_CFG["k"], 2), n=1024)
                    .contiguous(), 256, 256, "PSM samples")

    print("[7] reference check on a small input")
    small_reference_check()

    print("[8] kernel timings at the main path's shapes")
    kernels = kernel_timings(main_res)
    for kern in kernels:
        print(f"    {kern['name'].split(' (')[0]}: {kern['ms']:.4f} ms (bound "
              f"{kern['bound_ms']:.4f} ms by {kern['bound_by']}), plain "
              f"{kern['plain_ms']:.4f} ms, library {kern['library_ms']}, "
              f"launches {kern['launches']} in {main_res['views']} views")
    print(f"    DSNT worst over the parity inputs: {dsnt_worst}")
    print(f"    total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
