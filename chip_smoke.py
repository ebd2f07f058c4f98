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
   (K2; 420 and 336 heatmaps, and 42 and 21 split into bands, one cluster
   each) and the column kernel (K1; 420 columns, 21 columns, and 420
   columns of a 512-wide buffer), random and sharp off-centre blob
   heatmaps, bf16, f16 and f32, at 256^2 and 64^2: mu <= 1e-4 px, sigma
   relative error <= 1e-3;
4. crossing-selection kernel (CUDA, K3) against its plain version on the
   zigzag contours of the JAX package's parity check and on the edge cases
   of ops/rasterize.py `selection_edge_cases` (tied crossings, horizontal
   edges, vertices outside the image, rows with more crossings than a
   bucket holds, NaN and infinite vertices): bitwise-equal crossings with
   NaN positions matched, 0 mismatched fill pixels; the rows that took the
   overflow path are counted and must not be 0; then the NaN rule alone
   (rows with a NaN candidate are all NaN, and the fill counts no crossing
   there) on a circle with a NaN vertex and on NaN and infinite vertices;
5. the main path: `run_predict` on synthetic CAMUS-like views with the
   flagship TMI serving configuration (8-stage UNet at full width, bf16,
   MC dropout T_e=10 x PSM T_a=25, 256^2, K=21) and seed-initialised
   weights; launch counters reset just before and read just after; outputs
   finite with the JAX package's shapes; steady-state views/s (without the
   results processors); the device's busy time per view from a profiled
   pass, and the top kernels; then the results processors of the flagship
   data config (point_metrics, calibration, clinical_metrics,
   instant_metrics, mutual_info) on the 6 views: no processor error, the
   CSVs and metrics.json written, every value finite where the CPU run of
   the same processors on the same views is, and the card's values equal
   to the CPU's (areas and FAC exactly, the rest within PROCESSOR_TOL);
   their host time per view and the clinical metrics' device time;
6. the crossing selection again on one view's 500 sampled contours;
7. the GPU path against the CPU path (plain versions) on a small input;
   the mask-space GLS functions of utils/clinical.py on the card against
   the CPU, with tied bottom-most base pixels (the first is taken);
8. kernel timings beside their bounds and plain versions at the main
   path's shapes; K2's band splits at the row counts of T_e=1, 5 and 10;
   K1's launch at the serving shape and K1 at 21 and 42 columns;
   the kernels JSON line (K1, K2, K3), the card line and the final
   {"ok": true, ...} line;
9. the training path, before the kernels line: `runner.run` at the
   flagship training configuration (8-stage UNet at full width, f32,
   `drop_block`, batch 32, 256^2, K=21, AdamW lr 1e-3 wd 1e-3, augmentation
   on) on 60 synthetic patients (4 batches per epoch), 3 epochs, then the
   test metrics and predict at T_e=1 with the five results processors;
   every loss finite, checkpoints and CSV written, no processor error and
   the clinical CSVs written over the 24 predicted views; ms/step and
   images/s, peak memory, launches per train step, val/test batch and predict view (K2 1, 1, 1; K3 0, 1, 1), and the idle
   share and top device rows of a profiled pass over 3 train steps. Then an
   overfit check (one fixed batch, 10 steps, the loss must fall); both
   moment Functions at (672, 65536) f32: their moments against the plain
   version in f64 (the bars of [3]) and their gradients against autograd of
   the plain version in f64, with K2's f32 forward and the plain backward
   timed; one SGD step on the GPU against the CPU (64^2, 4 stages), also
   with K2 swapped for the plain moments and with cuDNN off, to tell the
   kernel's share of the difference from the convolutions'; and, on the
   trained weights' own logits of one validation batch, K2 at 672, 336 and
   42 rows (the train step and full validation batch, the last validation
   batch, a predicted view) against f64 and the crossing selection against
   its plain version on the batch's linear polygons (E=168).

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and f32 outside
# the tensor cores. Bounds below are computed from this run's inputs.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

DSNT_BARS = {"mu_px": 1e-4, "sigma_rel": 1e-3}

MAIN_CFG = dict(t_e=10, t_a=25, size=256, k=21, n_patients=8, seed=0)
STEADY_PASSES = 5  # timed passes over the test views after the first

# The training path: the flagship `runner.py data=camus-cont task=dsnt-al`
# run at full width, on the synthetic source (60 patients: 144 training
# frames, 4 batches of 32 per epoch; 48 validation and 48 test frames).
TRAIN_CFG = dict(n_patients=60, epochs=3, batch=32, seed=0)
TRAIN_DIR = Path("outputs") / "chip_smoke_train"  # git-ignored, removed at the end
# The flagship data config's results processors (config/json/data/camus-cont.json).
PROCESSOR_NAMES = ["point_metrics", "calibration", "clinical_metrics", "instant_metrics",
                   "mutual_info"]
# The card's processor outputs against the CPU's on the same views: values
# downstream of the clinical f32 reductions (spline perimeters, Simpson
# volumes: GLS, EDV, ESV, EF, Volume and their stds, errors, correlations
# and UCE) within atol + rtol * |cpu|; all other values, the areas and FAC
# included, equal.
PROCESSOR_TOL = {"rtol": 5e-5, "atol": 1e-5}
DEVICE_REDUCED = ("GLS", "EDV", "ESV", "EF", "Volume")
TRAIN_OVERRIDES = [
    "data=synthetic", f"data.n_patients={TRAIN_CFG['n_patients']}", "data.image_size=256",
    "task=dsnt-al", "task/model=unet2", "task.model.drop_block=true",
    "task.optim.name=adamw", "task.optim.lr=1e-3", "task.optim.weight_decay=1e-3",
    f"trainer.batch_size={TRAIN_CFG['batch']}", f"trainer.max_epochs={TRAIN_CFG['epochs']}",
    "trainer.augment=true", f"trainer.save_every={TRAIN_CFG['epochs']}",
    f"seed={TRAIN_CFG['seed']}", f"save_path={TRAIN_DIR}",
    f"task.psm_path={TRAIN_DIR / 'psm.npz'}",
    f"data.results_processors=[{', '.join(PROCESSOR_NAMES)}]",
]
# K2's gradient against autograd of the plain version in f64, relative to
# the largest gradient: the adjoint recomputes p in f32 (CPU: 1.8e-7).
GRAD_BAR = 1e-5
# One optimizer step, GPU against CPU (f32 convolutions, TF32 off; see
# gpu_vs_cpu_step): per gradient leaf, a share of the leaf's largest f64
# value plus 1e-5 of the largest gradient of all, and each weight within the
# learning rate times that bar plus 2e-7 (f32 rounding of weights of order
# 1). The path as it runs is held to 1e-2 of a leaf: with cuDNN's f32
# algorithms its weight gradients sit up to 5.5e-3 of their leaf from f64,
# with K2 or with the plain moments alike; with cuDNN off, 5.8e-4; the
# CPU's, 9.4e-7 (PERF.md). So the step with cuDNN off is held to 1e-3 of
# f64, and K2 to 1e-5 of the plain moments on the same convolutions (8.1e-7
# measured). The conv biases ahead of an instance norm have an exact
# gradient of 0: theirs is rounding noise, held under 1e-3 of the largest
# gradient.
STEP_BARS = {"grad_leaf": 1e-2, "no_cudnn": 1e-3, "kernel_vs_plain": 1e-5, "grad_all": 1e-5,
             "param_round": 2e-7, "zero_grad": 1e-3}


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


def moment_errors(raw, ref, height: int, width: int) -> dict:
    """Moments `raw` against the f64 moments `ref` of the same heatmaps, as
    pixel Gaussians: the largest mu error (px) and the largest sigma error
    relative to the reference's mean variance."""
    from contouring_uncertainty_torch.ops.dsnt import raw6_to_pixel_gaussians

    mu_r, sig_r = raw6_to_pixel_gaussians(ref[:, :6], height, width)
    scale = (sig_r[:, 0, 0] + sig_r[:, 1, 1])[:, None, None] / 2.0
    mu_k, sig_k = raw6_to_pixel_gaussians(raw[:, :6].double(), height, width)
    return {"mu_px": (mu_k - mu_r).abs().max().item(),
            "sigma_rel": ((sig_k - sig_r).abs() / scale).max().item()}


def within_dsnt_bars(err: dict) -> bool:
    return err["mu_px"] <= DSNT_BARS["mu_px"] and err["sigma_rel"] <= DSNT_BARS["sigma_rel"]


def check_dsnt(size: int, n: int = 420) -> dict:
    """Both moment kernels against f64 on n random and n blob heatmaps of
    size^2: K2 on the row layout (all n heatmaps, one block each; the first
    336, a 16-frame validation batch; the first 42, two frames at T_e=1,
    and the first 21, both split into bands), K1 on the column layout (all
    n, the first 21, and n columns of a 512-wide buffer)."""
    import torch

    from contouring_uncertainty_torch.ops import dsnt_kernel

    worst = {"mu_px": 0.0, "sigma_rel": 0.0}
    for name, x in dsnt_inputs(n, size, np.random.default_rng(7)).items():
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            xt = torch.as_tensor(x, device="cuda").to(dtype)
            ref = dsnt_kernel.raw_moments_plain(xt.double(), size, size)
            few = xt[:21]
            bands = {r: dsnt_kernel.row_bands(r, size, size, xt.element_size(), n_sm())
                     for r in (21, 42)}
            wide = torch.full((size * size, 512), float("nan"), device="cuda", dtype=dtype)
            wide[:, :n] = xt.t()
            layouts = {
                "rows (K2)": (dsnt_kernel.raw_moments_cuda(xt, size, size), slice(None)),
                "rows, 336 (K2)":
                    (dsnt_kernel.raw_moments_cuda(xt[:336], size, size), slice(0, 336)),
                f"rows, 42 in {bands[42]} bands (K2)":
                    (dsnt_kernel.raw_moments_cuda(xt[:42], size, size), slice(0, 42)),
                f"rows, 21 in {bands[21]} bands (K2)":
                    (dsnt_kernel.raw_moments_cuda(few, size, size), slice(0, 21)),
                f"cols, {n} (K1)": (dsnt_kernel.dsnt_raw_moments_cols(xt.t().contiguous(), size,
                                                                      size), slice(None)),
                "cols, 21 (K1)": (dsnt_kernel.dsnt_raw_moments_cols(few.t().contiguous(), size,
                                                                    size), slice(0, 21)),
                f"cols, {n} of 512 (K1)": (dsnt_kernel.dsnt_raw_moments_cols(wide[:, :n], size,
                                                                             size), slice(None)),
            }
            for layout, (raw, sel) in layouts.items():
                err = moment_errors(raw, ref[sel], size, size)
                print(f"  dsnt {size}^2 {name:6s} {str(dtype):14s} {layout}: "
                      f"mu err {err['mu_px']:.3e} px, sigma rel err {err['sigma_rel']:.3e}")
                worst = {k: max(worst[k], err[k]) for k in worst}
    torch.cuda.synchronize()
    if not within_dsnt_bars(worst):
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
    unequal = int(((xs_k != xs_p) & ~(xs_k.isnan() & xs_p.isnan())).sum().item())
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
    """The NaN rule of the crossing selection (the JAX Pallas kernel's): a
    row whose candidates hold a NaN comes out all NaN, in the kernel as in
    the plain version, and the fill counts no crossing there. On a circle
    of 64 vertices (radius 8 about (16, 16), 32 rows) with vertex 5 NaN,
    rows 0-20 are NaN; on circles of 32 vertices (16 rows) with a NaN x, a
    NaN y, an infinite x and an infinite y, each has NaN rows. The kernel
    equals the plain version bitwise with NaN positions matched, and its
    fills equal the plain fills."""
    import torch

    from contouring_uncertainty_torch.ops import select_kernel
    from contouring_uncertainty_torch.ops.rasterize import fill_from_crossings, nan_circle

    angle = np.linspace(0.0, 2.0 * np.pi, 32, endpoint=False)
    circle = np.stack([8.0 + 5.5 * np.cos(angle), 8.0 + 5.5 * np.sin(angle)], -1)
    polys = np.repeat(circle[None].astype(np.float32), 4, axis=0)
    polys[0, 3, 1] = np.nan
    polys[1, 0, 0] = np.nan
    polys[2, 20, 1] = np.inf
    polys[3, 27, 0] = -np.inf
    for label, arr, height in (("NaN vertex 5 of a 64-vertex circle", nan_circle()[None], 32),
                               ("NaN and infinite vertices", polys, 16)):
        dense = torch.as_tensor(arr, device="cuda")
        got = select_kernel.min_k_crossings_kernel(dense, height)
        ref = select_kernel.min_k_crossings_plain(dense, height)
        nan_rows = ref.isnan().all(-1)
        unequal = int(((got != ref) & ~(got.isnan() & ref.isnan())).sum().item())
        nan_unequal = int((got.isnan() != ref.isnan()).sum().item())
        fills = [fill_from_crossings(xs, dense, height) for xs in (got, ref)]
        mismatch = int((fills[0] != fills[1]).sum().item())
        print(f"  selection {label}: rows all NaN per polygon "
              f"{nan_rows.sum(-1).tolist()}; crossings differing {unequal} (NaN positions "
              f"differing {nan_unequal}), fill pixels differing {mismatch}")
        if unequal or mismatch or not nan_rows.any(-1).all():
            raise AssertionError(f"crossing selection's NaN rule fails ({label})")
        if not bool((ref.isnan().any(-1) == nan_rows).all()):
            raise AssertionError(f"the plain selection has partly NaN rows ({label})")
        if height == 32 and nan_rows[0].nonzero().flatten().tolist() != list(range(21)):
            raise AssertionError(f"NaN rows of the circle: {nan_rows[0].nonzero().tolist()}")


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


def read_csv_cells(path: Path):
    """(header, rows) of a CSV the processors wrote, as strings."""
    import csv

    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f))
    return header, rows


def differing(name: str, got, ref) -> int:
    """1 if a card value differs from the CPU's beyond PROCESSOR_TOL (values
    downstream of the clinical f32 reductions) or at all (the others), NaN
    matching NaN; 0 otherwise. Strings are compared as text."""
    try:
        g, r = float(got), float(ref)
    except (TypeError, ValueError):
        return int(got != ref)
    if np.isnan(g) or np.isnan(r):
        return int(np.isnan(g) != np.isnan(r))
    if any(m in name for m in DEVICE_REDUCED):
        return int(abs(g - r) > PROCESSOR_TOL["atol"] + PROCESSOR_TOL["rtol"] * abs(r))
    return int(g != r)


PROCESSOR_FILES = ["metrics.json", "instant_metrics.csv", "data_instant.npy", "data_point.npy",
                   *(f"clinical/{t}_df.csv" for t in ("instant", "view", "patient", "volume"))]
CSV_FILES = [f for f in PROCESSOR_FILES if f.endswith(".csv")]


def processors_check(results, profile_dir=None) -> dict:
    """The flagship data config's results processors on the main path's
    views: on the card (checked, then timed; the clinical metrics alone
    timed and profiled), then on the CPU, whose outputs the card's must
    equal within PROCESSOR_TOL."""
    import tempfile

    import torch

    from contouring_uncertainty_torch.results import run_processors

    cfg = {"data": {"results_processors": PROCESSOR_NAMES}}
    clinical_cfg = {"data": {"results_processors": ["clinical_metrics"]}}
    n_views = len(results)

    def timed(out_dir, config, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = run_processors(results, out_dir, config, device=device)
        torch.cuda.synchronize()
        return metrics, (time.perf_counter() - t0) * 1e3 / n_views

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        gpu, first_ms = timed(tmp / "gpu", cfg, "cuda")
        if "processor_errors" in gpu:
            raise AssertionError(f"processor errors on the card: {gpu['processor_errors']}")
        missing = [f for f in PROCESSOR_FILES if not (tmp / "gpu" / f).exists()]
        if missing:
            raise AssertionError(f"the processors did not write {missing}")
        _, host_ms = timed(tmp / "gpu2", cfg, "cuda")
        _, clinical_ms = timed(tmp / "clinical", clinical_cfg, "cuda")
        kernel_ms, copy_ms, table = profile_run(
            lambda: run_processors(results, tmp / "clinical2", clinical_cfg, device="cuda"),
            profile_dir / "processors" if profile_dir is not None else None)
        cpu, cpu_ms = timed(tmp / "cpu", cfg, "cpu")

        if set(gpu) != set(cpu):
            raise AssertionError(f"summary keys differ: {sorted(set(gpu) ^ set(cpu))}")
        bad = {k: (gpu[k], cpu[k]) for k in cpu if differing(k, gpu[k], cpu[k])}
        cells = 0
        for name in CSV_FILES:
            header, rows = read_csv_cells(tmp / "gpu" / name)
            ref_header, ref_rows = read_csv_cells(tmp / "cpu" / name)
            if header != ref_header or [r[0] for r in rows] != [r[0] for r in ref_rows]:
                raise AssertionError(f"{name}: the card's columns or rows differ from the CPU's")
            for row, ref_row in zip(rows, ref_rows):
                for col, got, ref in zip(header[1:], row[1:], ref_row[1:]):
                    cells += 1
                    if differing(col, got, ref):
                        bad[f"{name}:{row[0]}:{col}"] = (got, ref)
        floats = [v for v in gpu.values() if isinstance(v, float)]
        non_finite = sorted(k for k, v in gpu.items() if isinstance(v, float)
                            and not np.isfinite(v))
        if bad:
            raise AssertionError(f"the card's processor outputs differ from the CPU's "
                                 f"(tolerance {PROCESSOR_TOL}): {dict(list(bad.items())[:10])}")
        for key in ("clinical_metrics/instant/Area_error", "clinical_metrics/view/FAC_error",
                    "clinical_metrics/view/GLS_error", "clinical_metrics/patient/EF_error",
                    "clinical_metrics/patient/EDV_error", "clinical_metrics/Volume_uce"):
            if not np.isfinite(gpu[key]):
                raise AssertionError(f"{key} is not finite: {gpu[key]}")
        patients = len(read_csv_cells(tmp / "gpu" / "clinical/patient_df.csv")[1])
    return {"keys": len(gpu), "floats": len(floats), "non_finite": non_finite, "cells": cells,
            "patients": patients, "first_ms_per_view": first_ms, "host_ms_per_view": host_ms,
            "clinical_host_ms_per_view": clinical_ms, "cpu_ms_per_view": cpu_ms,
            "clinical_kernel_ms_per_view": kernel_ms / n_views,
            "clinical_copy_ms_per_view": copy_ms / n_views, "clinical_profile": table}


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


def clinical_mask_check() -> None:
    """The mask-space GLS of utils/clinical.py on the card against the CPU:
    base markers (equal, on frontiers whose bottom row ties, where the first
    pixel is taken as `jnp.argmax` takes it) and longitudinal lengths
    (1e-6 relative), on LV and myocardium label maps and on a flat-bottomed
    LV alone."""
    import torch

    from contouring_uncertainty_torch.utils import clinical as C

    size = 64
    yy, xx = np.mgrid[0:size, 0:size]
    segs = np.zeros((4, size, size), np.float32)
    for i, scale in enumerate((1.0, 0.9, 0.8)):
        ry, rx = 23 * scale, 13 * scale
        lv = (((yy - 40) / ry) ** 2 + ((xx - 32) / rx) ** 2 <= 1) & (yy <= 40)
        outer = (((yy - 40) / (ry + 5)) ** 2 + ((xx - 32) / (rx + 5)) ** 2 <= 1) & (yy <= 40)
        segs[i][outer & ~lv] = 2
        segs[i][lv] = 1
    segs[3, 10:30, 12:40] = 1  # flat bottom: ties along row 29
    for use_myo in (True, False):
        cpu = C.mask_endo_base(torch.as_tensor(segs), use_myo=use_myo)
        gpu = C.mask_endo_base(torch.as_tensor(segs, device="cuda"), use_myo=use_myo)
        flat = [(a.cpu(), b) for a, b in zip(
            (gpu[0][0], gpu[0][1], gpu[1][0], gpu[1][1], gpu[2]),
            (cpu[0][0], cpu[0][1], cpu[1][0], cpu[1][1], cpu[2]))]
        len_gpu = C.mask_longitudinal_length(torch.as_tensor(segs, device="cuda"),
                                             use_myo=use_myo).cpu()
        len_cpu = C.mask_longitudinal_length(torch.as_tensor(segs), use_myo=use_myo)
        print(f"    mask GLS, use_myo={use_myo}: base markers (y, x) left "
              f"{list(zip(gpu[0][0].tolist(), gpu[0][1].tolist()))}, right "
              f"{list(zip(gpu[1][0].tolist(), gpu[1][1].tolist()))}; lengths "
              f"{[round(v, 3) for v in len_gpu.tolist()]}")
        if not all(torch.equal(a, b) for a, b in flat):
            raise AssertionError(f"base markers differ on the card (use_myo={use_myo})")
        torch.testing.assert_close(len_gpu, len_cpu, rtol=1e-6, atol=0, equal_nan=True)
    left = (gpu[0][0][3].item(), gpu[0][1][3].item())
    if left != (29.0, 12.0):
        raise AssertionError(f"tied base pixels: the first is (29, 12), the card took {left}")


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


@contextmanager
def launch_ledger():
    """Per call of a train step, a val/test batch (`val_metrics`) and a
    predicted view, the (K2, K1, K3) launches it made; the class methods are
    wrapped while the block runs."""
    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel
    from contouring_uncertainty_torch.predict import AleatoricPredictor
    from contouring_uncertainty_torch.tasks import DSNTAleatoric
    from contouring_uncertainty_torch.train import Trainer

    def counts():
        return (dsnt_kernel.row_launches, dsnt_kernel.col_launches, select_kernel.launches)

    ledger = {"train step": [], "val/test batch": [], "predict view": []}
    targets = [(Trainer, "train_step", "train step"),
               (DSNTAleatoric, "val_metrics", "val/test batch"),
               (AleatoricPredictor, "__call__", "predict view")]
    originals = [getattr(cls, name) for cls, name, _ in targets]

    def counted(fn, label):
        def wrapper(*args, **kwargs):
            before = counts()
            out = fn(*args, **kwargs)
            ledger[label].append(tuple(a - b for a, b in zip(counts(), before)))
            return out
        return wrapper

    for (cls, name, label), fn in zip(targets, originals):
        setattr(cls, name, counted(fn, label))
    try:
        yield ledger
    finally:
        for (cls, name, _), fn in zip(targets, originals):
            setattr(cls, name, fn)


def training_run() -> dict:
    """runner.run at the flagship training configuration, launches counted."""
    import torch

    from contouring_uncertainty_torch import runner
    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dsnt_kernel.row_launches = dsnt_kernel.col_launches = 0
    select_kernel.launches = 0
    t0 = time.perf_counter()
    with launch_ledger() as ledger:
        result = runner.run(TRAIN_OVERRIDES)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    totals = {"K2": dsnt_kernel.row_launches, "K1": dsnt_kernel.col_launches,
              "K3": select_kernel.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # Gates: finite losses, the files a run leaves, launches where expected.
    history = result["history"]
    if len(history) != TRAIN_CFG["epochs"]:
        raise AssertionError(f"trained {len(history)} epochs, expected {TRAIN_CFG['epochs']}")
    for row in history:
        bad = {k: v for k, v in row.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite training log at epoch {row['epoch']}: {bad}")
    if "test_error" in result or not all(np.isfinite(v) for v in result["test_metrics"].values()):
        raise AssertionError(f"test pass failed: {result.get('test_error', result.get('test_metrics'))}")
    name = Path(result["ckpt_path"]).name[:-len(".ckpt")]
    run_dir = Path(result["ckpt_path"]).parent
    for path in (run_dir / f"{name}.ckpt" / "state.pt", run_dir / f"{name}.ckpt" / "meta.json",
                 run_dir / f"{name}_last.ckpt" / "state.pt", run_dir / f"{name}_metrics.csv",
                 run_dir / f"{name}_phases.json", run_dir / "train_complete"):
        if not path.exists():
            raise AssertionError(f"the training run did not write {path}")
    csv_rows = (run_dir / f"{name}_metrics.csv").read_text().strip().splitlines()
    if len(csv_rows) != 1 + TRAIN_CFG["epochs"]:
        raise AssertionError(f"metrics CSV has {len(csv_rows)} lines")
    if "processor_errors" in result:
        raise AssertionError(f"processor errors in the training run: {result['processor_errors']}")
    n_views = len(result["predict"])
    clinical = TRAIN_DIR / "results" / "clinical"
    expected_rows = {"instant": 2 * n_views, "view": n_views, "patient": n_views // 2,
                     "volume": n_views}
    for table, n_rows in expected_rows.items():
        path = clinical / f"{table}_df.csv"
        if not path.exists() or len(read_csv_cells(path)[1]) != n_rows:
            raise AssertionError(f"{path} is missing or has not {n_rows} rows")
    k = 21
    for res in result["predict"]:
        n = res.img.shape[0]
        if res.mu.shape != (n, k, 2) or res.contour_samples.shape != (n, 1, 25, k, 2):
            raise AssertionError(f"predict shapes {res.mu.shape} {res.contour_samples.shape}")
        if not (np.isfinite(res.mu).all() and np.isfinite(res.cov).all()
                and np.isfinite(res.uncertainty_map).all()):
            raise AssertionError("predict output has non-finite values")
    expected = {"train step": (1, 0, 0), "val/test batch": (1, 0, 1), "predict view": (1, 0, 1)}
    for label, calls in ledger.items():
        if not calls or any(c != expected[label] for c in calls):
            raise AssertionError(f"launches (K2, K1, K3) per {label}: {calls}, expected "
                                 f"{expected[label]} in every call")
    summed = [sum(c[i] for calls in ledger.values() for c in calls) for i in range(3)]
    if summed != [totals["K2"], totals["K1"], totals["K3"]]:
        raise AssertionError(f"launches outside the counted calls: totals {totals}, "
                             f"counted {summed}")

    phases = json.loads((run_dir / f"{name}_phases.json").read_text())
    steps = phases["train_step"]["samples_ms"]
    per_epoch = len(steps) // TRAIN_CFG["epochs"]
    later = sorted(steps[per_epoch:])
    median_ms = later[len(later) // 2]
    return {"history": history, "test": result["test_metrics"], "wall_s": wall_s,
            "ckpt": result["ckpt_path"], "views": len(result["predict"]),
            "clinical_rows": expected_rows,
            "ledger": {label: len(calls) for label, calls in ledger.items()},
            "per_call": expected, "totals": totals, "peak_gib": peak_gib,
            "step_ms": median_ms, "step_ms_range": (later[0], later[-1]),
            "first_step_ms": steps[0], "images_per_s": TRAIN_CFG["batch"] / median_ms * 1e3,
            "eval_ms": phases.get("eval_step", {}).get("median_ms")}


def train_profile_and_overfit(profile_dir=None) -> dict:
    """The flagship configuration's train step on one batch: 2 warm-up
    steps, 3 timed steps (host clock, synchronised), 3 steps under
    torch.profiler for the device time; then the overfit check: 10 more
    steps on the same batch without augmentation, the loss must fall."""
    import torch

    from contouring_uncertainty_torch.config import compose
    from contouring_uncertainty_torch.data.config import Tags
    from contouring_uncertainty_torch.factory import build_data, build_task, build_trainer
    from contouring_uncertainty_torch.train.trainer import _iterate, _to_device

    cfg = compose(TRAIN_OVERRIDES)
    data = build_data(cfg)
    task = build_task(cfg, data.data_params)
    trainer = build_trainer(cfg, task)
    trainer.init_state()
    arrays = data.train_arrays("train")
    batch = _to_device(next(_iterate(arrays, TRAIN_CFG["batch"], np.random.default_rng(1))),
                       trainer.device)
    for step in range(2):
        trainer.train_step(batch, step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(2, 5):
        trainer.train_step(batch, step)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms, copy_ms, table = profile_run(
        lambda: [trainer.train_step(batch, step) for step in range(5, 8)],
        profile_dir / "train" if profile_dir is not None else None)
    trainer.config.augment = False
    losses = [float(trainer.train_step(batch, step)["loss"]) for step in range(8, 18)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the loss on one fixed batch did not fall: {losses}")
    return {"kernel_ms": kernel_ms / 3, "copy_ms": copy_ms / 3, "wall_ms": wall_ms / 3,
            "table": table, "losses": losses, "img_shape": tuple(batch[Tags.img].shape)}


def moment_gradients() -> dict:
    """Both moment Functions at the training head's shape, (32*21, 256^2)
    f32: their moments (K2 and K1) against the plain version in f64 within
    DSNT_BARS, their gradients on the card against autograd of the plain
    version in f64; K2's f32 forward, the plain forward and the plain
    backward timed."""
    import torch

    from contouring_uncertainty_torch.ops import dsnt_kernel
    from contouring_uncertainty_torch.ops.dsnt import logits_to_pixel_gaussians

    size, rows = 256, TRAIN_CFG["batch"] * 21
    x_np = np.concatenate(list(dsnt_inputs(rows // 2, size, np.random.default_rng(3)).values()))
    x = torch.as_tensor(x_np, device="cuda")
    g = torch.as_tensor(np.random.default_rng(4).normal(size=(rows, 8)).astype(np.float32),
                        device="cuda")
    xd = x.double().requires_grad_()
    raw_ref = dsnt_kernel.raw_moments_plain(xd, size, size)
    raw_ref.backward(g.double())
    ref, raw_ref = xd.grad, raw_ref.detach()
    del xd
    errs, moment_errs = {}, {}
    before = (dsnt_kernel.row_launches, dsnt_kernel.col_launches)
    for name, view in (("K2 rows", x), ("K1 cols", x.t().contiguous())):
        leaf = view.clone().requires_grad_()
        fn = dsnt_kernel.dsnt_raw_moments if name.startswith("K2") else dsnt_kernel.dsnt_raw_moments_cols
        out = fn(leaf, size, size)
        if out.grad_fn is None:
            raise AssertionError(f"{name}: no grad_fn on the card")
        moment_errs[name] = moment_errors(out.detach(), raw_ref, size, size)
        moment_errs[name]["max_abs_err"] = (out.detach().double() - raw_ref).abs().max().item()
        (grad,) = torch.autograd.grad(out, leaf, g)
        grad = grad if name.startswith("K2") else grad.t()
        errs[name] = ((grad.double() - ref).abs().max() / ref.abs().max()).item()
    launched = (dsnt_kernel.row_launches - before[0], dsnt_kernel.col_launches - before[1])
    if launched != (1, 1):
        raise AssertionError(f"the Functions launched (K2, K1) {launched}, expected (1, 1)")
    mu, sigma = logits_to_pixel_gaussians(x[:42].reshape(2, 21, size, size).requires_grad_())
    if mu.grad_fn is None or sigma.grad_fn is None:
        raise AssertionError("logits_to_pixel_gaussians carries no gradient on the card")
    if max(errs.values()) > GRAD_BAR:
        raise AssertionError(f"moment gradients off by {errs} (bar {GRAD_BAR})")
    if not all(within_dsnt_bars(e) for e in moment_errs.values()):
        raise AssertionError(f"moments at the training shape outside {DSNT_BARS}: {moment_errs}")
    fwd_ms = cuda_ms(lambda: dsnt_kernel.raw_moments_cuda(x, size, size))
    plain_ms = cuda_ms(lambda: dsnt_kernel.raw_moments_plain(x, size, size), iters=5)
    bwd_ms = cuda_ms(lambda: dsnt_kernel.moments_adjoint(x, g, size, size), iters=5)
    n_bytes = x.numel() * 4 + rows * 8 * 4
    bound = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "operations": rows * size * size * 19 / F32_OPS_PER_S * 1e3}
    # The adjoint reads the logits and the cotangents and writes the
    # gradient once; per pixel a max, exp, the basis polynomial (8 terms)
    # and two products and sums.
    bwd_bound = {"bytes": (2 * x.numel() * 4 + rows * 8 * 4) / HBM_BYTES_PER_S * 1e3,
                 "operations": rows * size * size * 24 / F32_OPS_PER_S * 1e3}
    return {"shape": [rows, size * size], "grad_rel_err": errs, "moment_err": moment_errs,
            "max_abs_err": moment_errs["K2 rows"]["max_abs_err"], "fwd_ms": fwd_ms,
            "fwd_bound_ms": max(bound.values()), "fwd_bound_by": max(bound, key=bound.get),
            "plain_fwd_ms": plain_ms, "plain_bwd_ms": bwd_ms,
            "bwd_bound_ms": max(bwd_bound.values()),
            "bwd_bound_by": max(bwd_bound, key=bwd_bound.get)}


@contextmanager
def step_variant(plain_moments: bool, cudnn: bool):
    """While the block runs: with `plain_moments`, the moment launchers
    replaced by the plain version on CUDA tensors (the Functions and their
    backward unchanged); without `cudnn`, cuDNN off, so convolutions and
    instance norm take PyTorch's own CUDA kernels (im2col and cuBLAS f32
    GEMMs for the convolutions)."""
    import torch

    from contouring_uncertainty_torch.ops import dsnt_kernel

    saved = (dsnt_kernel.raw_moments_cuda, dsnt_kernel.raw_moments_cols_cuda,
             torch.backends.cudnn.enabled)
    if plain_moments:
        dsnt_kernel.raw_moments_cuda = (
            lambda x, h, w, bands=None: dsnt_kernel.raw_moments_plain(x, h, w))
        dsnt_kernel.raw_moments_cols_cuda = (
            lambda x, h, w: dsnt_kernel.raw_moments_plain(x.t(), h, w))
    torch.backends.cudnn.enabled = cudnn
    try:
        yield
    finally:
        (dsnt_kernel.raw_moments_cuda, dsnt_kernel.raw_moments_cols_cuda,
         torch.backends.cudnn.enabled) = saved


STEP_VARIANTS = {"path": (False, True), "plain moments": (True, True),
                 "no cuDNN": (False, False), "plain moments, no cuDNN": (True, False)}


def gpu_vs_cpu_step() -> dict:
    """One SGD update on the GPU against the CPU: 64^2, 4 stages,
    drop_block off, augmentation off, the same seed-initialised weights and
    batch; every gradient also against the CPU's in f64. The GPU step runs
    in the STEP_VARIANTS: the path as the trainer runs it (K2, cuDNN), K2
    swapped for the plain moments, cuDNN off, and both. Gates (STEP_BARS,
    per gradient leaf, relative to its largest f64 value): the path within
    `grad_leaf` of the CPU and its weights within lr times that; K2 against
    the plain moments with cuDNN off (the same deterministic convolutions)
    within `kernel_vs_plain`; K2 with cuDNN off within `no_cudnn` of f64.
    SGD, not the slice's AdamW: AdamW's first step is lr * sign(g) wherever
    |g| >> eps, so on the biases whose gradient is rounding noise of either
    sign it sets the two devices' weights 2 lr apart; SGD keeps the update
    proportional to the gradient."""
    import torch

    from contouring_uncertainty_torch.data.config import DataParams, Tags
    from contouring_uncertainty_torch.data.synthetic import make_arrays
    from contouring_uncertainty_torch.tasks import DSNTAleatoric
    from contouring_uncertainty_torch.train import Trainer, TrainerConfig

    imgs, gts, contours = make_arrays(8, size=64, seed=2)
    task = DSNTAleatoric(
        data_params=DataParams(in_shape=(1, 64, 64), out_shape=(21, 2)),
        model_kwargs=dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3,
                          drop_block=False))
    cfg = TrainerConfig(optimizer="sgd", augment=False, seed=5)

    def batch_on(device, dtype=torch.float32):
        return {Tags.img: torch.as_tensor(imgs, device=device, dtype=dtype),
                Tags.gt: torch.as_tensor(gts, device=device),
                Tags.contour: torch.as_tensor(contours, device=device, dtype=dtype)}

    def one_step(device):
        trainer = Trainer(task, cfg, device=device)
        trainer.init_state()
        loss = float(trainer.train_step(batch_on(device), 0)["loss"])
        return loss, {n: (p.grad.detach().cpu().double(), p.detach().cpu())
                      for n, p in trainer.model.named_parameters()}

    out = {"cpu": one_step("cpu")}
    for variant, flags in STEP_VARIANTS.items():
        with step_variant(*flags):
            out[variant] = one_step("cuda")
    model64 = task.build_model(device="cpu",
                               generator=torch.Generator().manual_seed(cfg.seed)).double()
    task.loss(model64, batch_on("cpu", torch.float64), train=True)[0].backward()
    ref = {n: p.grad for n, p in model64.named_parameters()}
    grad_all = max(float(g.abs().max()) for g in ref.values())
    # Conv biases ahead of an instance norm: an exact gradient of 0.
    zero = [n for n in ref if n.endswith("Conv_0.bias")]
    leaves = [n for n in ref if n not in zero]

    def worst(grads, against):
        """The largest |difference| per leaf over the leaf's largest f64
        value, and that leaf."""
        ratio = {n: float((grads[n][0] - against[n]).abs().max()) / float(ref[n].abs().max())
                 for n in leaves}
        name = max(ratio, key=ratio.get)
        return ratio[name], name

    grads = {k: {n: v[0] for n, v in o[1].items()} for k, o in out.items()}
    readings = {f"{k} vs f64": worst(o[1], ref) for k, o in out.items()}
    readings["K2 vs plain moments, no cuDNN"] = worst(out["no cuDNN"][1],
                                                      grads["plain moments, no cuDNN"])
    readings["K2 vs plain moments, cuDNN"] = worst(out["path"][1], grads["plain moments"])
    readings["path vs cpu"] = worst(out["path"][1], grads["cpu"])
    for label, (ratio, name) in readings.items():
        print(f"      {label:32s} {ratio:.3e} of a leaf's largest ({name})")
    zero_noise = max(float(g[n].abs().max()) for g in grads.values() for n in zero) / grad_all

    def of_bar(a, b, leaf_bar):
        """Worst |a - b| per leaf as a share of leaf_bar * leaf max plus
        grad_all * the largest gradient of all."""
        return max(float((grads[a][n] - grads[b][n] if b else grads[a][n] - ref[n]).abs().max())
                   / (leaf_bar * float(ref[n].abs().max()) + STEP_BARS["grad_all"] * grad_all)
                   for n in leaves)

    grad_bar = {n: STEP_BARS["grad_leaf"] * float(ref[n].abs().max())
                + STEP_BARS["grad_all"] * grad_all for n in leaves}
    param = max(float((out["path"][1][n][1] - out["cpu"][1][n][1]).abs().max())
                / (cfg.lr * grad_bar[n] + STEP_BARS["param_round"]) for n in leaves)
    gates = {"path vs cpu": of_bar("path", "cpu", STEP_BARS["grad_leaf"]),
             "path weights vs cpu": param,
             "K2 vs plain moments, no cuDNN": of_bar("no cuDNN", "plain moments, no cuDNN",
                                                     STEP_BARS["kernel_vs_plain"]),
             "no cuDNN vs f64": of_bar("no cuDNN", None, STEP_BARS["no_cudnn"]),
             "zero-gradient biases": zero_noise / STEP_BARS["zero_grad"]}
    loss_err = abs(out["path"][0] - out["cpu"][0])
    if max(gates.values()) > 1.0:
        raise AssertionError(f"GPU step outside its bars: {gates} (shares of the bars "
                             f"{STEP_BARS})")
    return {"of_bar": gates, "readings": {k: v[0] for k, v in readings.items()},
            "loss_abs": loss_err, "loss": out["cpu"][0]}


def trained_head_checks(ckpt: str) -> dict:
    """The trained weights on one validation batch (32 frames): K2 on the
    head's own f32 logits at the row counts the training path gives it
    (672: a train step or a full validation batch; 336: the last, 16-frame
    validation and test batch; 42: a predicted view at T_e=1, two frames,
    split into bands) against the plain version in f64 within DSNT_BARS;
    then the crossing selection on the batch's linear polygons (21
    landmarks x 8 sub-edges = 168 edges) against its plain version."""
    import torch

    from contouring_uncertainty_torch.config import compose
    from contouring_uncertainty_torch.data.config import Tags
    from contouring_uncertainty_torch.factory import build_data, build_task
    from contouring_uncertainty_torch.ops import dsnt_kernel
    from contouring_uncertainty_torch.ops.rasterize import _densify_linear
    from contouring_uncertainty_torch.train.checkpoint import restore_checkpoint

    cfg = compose(TRAIN_OVERRIDES)
    data = build_data(cfg)
    task = build_task(cfg, data.data_params)
    model = task.build_model()
    model.load_state_dict(restore_checkpoint(ckpt, map_location="cuda")["params"])
    img = torch.as_tensor(data.train_arrays("val")[Tags.img][:TRAIN_CFG["batch"]], device="cuda")
    with torch.no_grad():
        logits = model(img, deterministic=True)["out"]
        mu, _ = task.forward_gaussians(model, img)
    size = logits.shape[-1]
    rows = logits.reshape(-1, size * size)
    ref = dsnt_kernel.raw_moments_plain(rows.double(), size, size)
    errs = {}
    for r in (rows.shape[0], rows.shape[0] // 2, 2 * logits.shape[1]):
        bands = dsnt_kernel.row_bands(r, size, size, rows.element_size(), n_sm())
        raw = dsnt_kernel.raw_moments_cuda(rows[:r], size, size)
        errs[r] = moment_errors(raw, ref[:r], size, size)
        print(f"    K2 on the trained head's logits, {r} rows {rows.dtype} in {bands} bands: "
              f"mu err {errs[r]['mu_px']:.3e} px, sigma rel err {errs[r]['sigma_rel']:.3e}")
    if not all(within_dsnt_bars(e) for e in errs.values()):
        raise AssertionError(f"K2 on the trained head outside {DSNT_BARS}: {errs}")
    dense = _densify_linear(mu, 8).contiguous()
    if dense.shape[1] != 168:
        raise AssertionError(f"validation polygons have {dense.shape[1]} edges, expected 168")
    check_selection(dense, size, size, f"validation polygons (E={dense.shape[1]})")
    return errs


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
    proc = processors_check(main_res["results"], profile_dir)
    print(f"    results processors {PROCESSOR_NAMES} on the {main_res['views']} views "
          f"({proc['patients']} patients with both views): {proc['keys']} summary keys, "
          f"{proc['floats']} floats, {len(proc['non_finite'])} not finite (as on the CPU: "
          f"{', '.join(k.split('/', 1)[1] for k in proc['non_finite'])}); "
          f"card vs CPU: {proc['cells']} CSV cells and every summary key within "
          f"{PROCESSOR_TOL} (areas and FAC equal)")
    print(f"    processors' host time per view (synchronised): "
          f"{proc['host_ms_per_view']:.1f} ms on the card (first call "
          f"{proc['first_ms_per_view']:.1f} ms), {proc['cpu_ms_per_view']:.1f} ms on the CPU; "
          f"clinical_metrics alone {proc['clinical_host_ms_per_view']:.1f} ms, of which device "
          f"time (profiled pass) kernels {proc['clinical_kernel_ms_per_view']:.2f} ms + copies "
          f"{proc['clinical_copy_ms_per_view']:.2f} ms, on {card}")
    print(proc["clinical_profile"])

    print("[6] crossing selection vs plain: one view's sampled contours")
    samples = torch.as_tensor(main_res["results"][0].contour_samples, device="cuda")
    check_selection(contour_spline(samples.reshape(-1, MAIN_CFG["k"], 2), n=1024)
                    .contiguous(), 256, 256, "PSM samples")

    print("[7] reference check on a small input")
    small_reference_check()
    clinical_mask_check()

    print("[8] kernel timings at the main path's shapes")
    kernels = kernel_timings(main_res)
    for kern in kernels:
        print(f"    {kern['name'].split(' (')[0]}: {kern['ms']:.4f} ms (bound "
              f"{kern['bound_ms']:.4f} ms by {kern['bound_by']}), plain "
              f"{kern['plain_ms']:.4f} ms, library {kern['library_ms']}, "
              f"launches {kern['launches']} in {main_res['views']} views")
    print(f"    DSNT worst over the parity inputs: {dsnt_worst}")

    print("[9] training path: runner.run, flagship training configuration "
          "(8-stage UNet, f32, drop_block, batch 32, 256^2, AdamW; TF32 off)")
    train = training_run()
    for row in train["history"]:
        print("    epoch {epoch}: train/loss {train/loss:.4f}, val/loss {val/loss:.4f}, "
              "val/dice {val/dice:.4f}, {time:.1f} s".format(**row))
    print(f"    test: {', '.join(f'{k} {v:.4f}' for k, v in train['test'].items())}; "
          f"{train['views']} views predicted at T_e=1; run {train['wall_s']:.1f} s")
    print(f"    results processors {PROCESSOR_NAMES}: no processor error; clinical rows "
          f"{train['clinical_rows']}")
    lo, hi = train["step_ms_range"]
    print(f"    train step: median {train['step_ms']:.1f} ms over the steps after the first "
          f"epoch (range {lo:.1f}-{hi:.1f}; first step {train['first_step_ms']:.1f}), "
          f"{train['images_per_s']:.1f} images/s; val/test batch median "
          f"{train['eval_ms']} ms; peak memory {train['peak_gib']:.2f} GiB on {card}")
    print(f"    launches (K2, K1, K3) per call, every call: {train['per_call']}; calls "
          f"{train['ledger']}; totals {train['totals']}")
    prof = train_profile_and_overfit(profile_dir)
    busy = (prof["kernel_ms"] + prof["copy_ms"]) / prof["wall_ms"]
    print(f"    profiled train steps ({prof['img_shape']}): {prof['wall_ms']:.1f} ms/step, "
          f"kernels {prof['kernel_ms']:.1f} ms + copies {prof['copy_ms']:.2f} ms = "
          f"{busy:.1%} busy; idle share {1 - busy:.1%}")
    print(prof["table"])
    print(f"    overfit, one batch, 10 steps: loss {prof['losses'][0]:.4f} -> "
          f"{prof['losses'][-1]:.4f}")
    grads = moment_gradients()
    print(f"    moment gradients at {grads['shape']} f32 vs plain f64: "
          f"{grads['grad_rel_err']} (bar {GRAD_BAR}); K2 f32 forward {grads['fwd_ms']:.4f} ms "
          f"(bound {grads['fwd_bound_ms']:.4f} ms by {grads['fwd_bound_by']}), plain forward "
          f"{grads['plain_fwd_ms']:.4f} ms, plain backward {grads['plain_bwd_ms']:.4f} ms "
          f"(bound {grads['bwd_bound_ms']:.4f} ms by {grads['bwd_bound_by']})")
    print(f"    moments at {grads['shape']} f32 vs plain f64: {grads['moment_err']} "
          f"(bars {DSNT_BARS})")
    print("    one SGD step, GPU vs CPU (64^2, 4 stages), worst gradient differences:")
    step = gpu_vs_cpu_step()
    print(f"    gates, each as a share of its bar: {step['of_bar']} (bars {STEP_BARS}); "
          f"loss {step['loss']:.6f} differs by {step['loss_abs']:.2e}")
    head_errs = trained_head_checks(train["ckpt"])
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    for kern in kernels:
        short = kern["name"].split(" ")[0]
        per_call = {label: calls[{"K2": 0, "K1": 1, "K3": 2}[short]]
                    for label, calls in train["per_call"].items()}
        kern["training"] = {"launches": train["totals"][short], "launches_per_call": per_call}
        if short == "K2":
            kern["training"].update({k: grads[k] for k in (
                "shape", "fwd_ms", "fwd_bound_ms", "fwd_bound_by", "plain_fwd_ms",
                "plain_bwd_ms", "bwd_bound_ms", "bwd_bound_by", "grad_rel_err", "max_abs_err",
                "moment_err")})
            kern["training"]["trained_head_err"] = head_errs
    print(f"    total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
