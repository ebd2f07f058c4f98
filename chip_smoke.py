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
2. build: nvcc for the four CUDA sources (csrc/min_k_crossings.cu,
   csrc/dsnt_moments.cu, csrc/conv_epilogue.cu, csrc/conv1x1_wgrad.cu) and
   g++ for the C++ batch prefetcher
   (csrc/prefetch_loader.cpp), all in parallel, from the sources in this
   checkout into contouring_uncertainty_torch/_build/, with ptxas's
   register report; a prefetcher that does not build fails the run;
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
5. the main path: `run_predict` on synthetic CAMUS-like views (the
   `data=synthetic` source: CamusContourData over the films the JAX
   package's write_camus_hdf5 draws, the landmarks extracted from the
   label masks, as in every synthetic phase below) with the flagship TMI
   serving configuration (8-stage UNet at full width, bf16,
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
   the kernels JSON line (K1, K2, K3, with the launches of the training,
   skew, sequence, batched, epistemic, segmentation, JSRT, CAMUS,
   backbone, ensemble, several-rank and figure paths), the card line and
   the final {"ok": true, ...} line;
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
   kernel's share of the difference from the convolutions', each step's
   gradients (the CPU's too) read against the model computing in f64
   throughout (`set_compute_dtype`), also pinned to the step's own side
   of every LeakyReLU kink (`leaky_relu_sides`), its kink flips counted;
   and, on the
   trained weights' own logits of one validation batch, K2 at 672, 336 and
   42 rows (the train step and full validation batch, the last validation
   batch, a predicted view) against f64 and the crossing selection against
   its plain version on the batch's linear polygons (E=168);
10. the skew path, before the kernels line: `run_predict` with a DSNTSkew
   task at the flagship serving width (the 8-stage UNet in bf16 with
   drop_block, its ConfidenceNet in f32, T_e=10 x T_a=25, 256^2, K=21) over
   the 6 test views with the esn skew PSM sampler, launch counters reset
   just before and read just after (K2 1 and K3 3 per view: the sample
   masks, the skew umap's 2L=200 level contours per frame and the mode's
   mask), outputs finite with the JAX package's shapes, views/s and the
   idle share, then the `grid` sampler on one view; the `skewness`
   processor from the card's entry point equal to the CPU's; K3 against its
   plain version on one view's 400 level contours (bitwise, NaN positions
   matched, the innermost nearly degenerate) and timed, K2 against f64 on
   the skew head's bf16 logits; the skew predictor on the GPU against the
   CPU at 64^2 (mu, cov, alpha, mode, umap); `runner.run` with
   task=dsnt-skew at the flagship training width (f32, batch 32, AdamW, 2
   epochs, every loss term finite, launches per train step, val/test batch
   and predicted view, ms/step, peak memory, the skewness processor after
   predict), and one freeze_seg epoch whose backbone stays bitwise the
   seed's;
11. the sequence samplers, soft masks and view batching, before the kernels
   line, at the serving width of [5]: `run_predict` with
   `task.sequence_sampler` over the 6 test views for DSNT-AL (K2 1 and K3 1
   launches per view) and for DSNTSkew with the esn sampler (K2 1, K3 3),
   launch counters reset just before and read just after, outputs finite
   with the JAX package's shapes, views/s and the idle share; both sequence
   samplers on the card on a synthetic (ED, ES) population (ES the ED
   contour shrunk by 0.8; T_e=10 x 25 pairs): each instant's mean within 8
   px of its prediction, the mean ES area below the mean ED area;
   `task.soft_mask` over the 6 views: f32 sample masks in [0, 1], the
   card's blur of one view's 500 masks within 1e-6 of the CPU's, the five
   flagship processors with no processor error; `predict_batch_views`=4
   over the 6 views (a dispatch of 4, then one of 2) for DSNT-AL and
   DSNTSkew (one forward per view, the rest of the pipeline once per
   dispatch): launches per dispatch (K2 1; K3 1 and 3), every view against
   one view per dispatch within the JAX package's budgets (mu 1e-5, cov
   1e-4, at most 8 `pred` pixels), views/s at V=1 and V=4 in turns in the
   same call with the idle share and top device rows of each; K2 on one
   dispatch's (1680, 65536) bf16 head logits against f64 (the bars of [3])
   and K3 on its 2000 sampled contours (bitwise, NaN positions matched),
   each timed beside its bound (K3 also beside `torch.topk`);
12. the segmentation baselines and the epistemic task, before the kernels
   line, at the serving width of [5] (8-stage UNet, bf16 trunk, 256^2, N=2,
   the 6 test views, seeded weights): `run_predict` of `mcdropout` (T_e=10,
   drop_block), `aleatoric` (T_a=25), `tta` (T_a=25) and `ssn` (rank 10,
   T_a=25), launch counters reset just before and read just after (K2 and
   K3: none), outputs with the JAX package's fields, shapes and dtypes
   (binary sample probabilities in [0, 1], a zero 10-px entropy border),
   views/s over 3 passes, idle share and top device rows; the morphology
   loop on one view's untrained sample masks (fixed-point iterations, host
   and device ms); the `data=camus` processors (instant_metrics,
   calibration, mutual_info, clinical_metrics through its mask-space GLS
   branch) on the card equal to the CPU within PROCESSOR_TOL; `epistemic`
   (T_e=10, T_a=25) with K2 1 and K3 1 per view, its task covariances
   exactly 0 and its fused covariance within 1e-5 of the f64 spread of the
   T_e means; each baseline's SegPredictor on the card against the CPU at
   64^2 (4-stage, f32, the same draws: probabilities within 1e-4, at most 8
   `pred` pixels per view, each at a mean probability within 1e-3 of 0.5;
   postprocess_batch bitwise, with an equal-size tie); each task trained at
   the width of [9] on one batch of 32 (a warm-up step, 4 timed steps with
   finite losses, launches counted, peak memory; 10 steps in which the
   loss falls);
13. the JSRT chest X-ray path, before the kernels line: 100 generated
   256^2 films (`make_jsrt_arrays`, fed through
   `JSRTContourData.from_arrays`; 60 train, 20 val, 20 test), K=120
   landmarks in three structures, one frame per view; `run_predict` at the
   serving width of [5] of DSNT-AL (K2 1, K3 2 per view: the samples' and
   mu's label maps, each one launch for the three structures), `mcdropout`
   on three classes (none) and `dsnt-skew5` (K2 1, K3 3), launch counters
   reset just before and read just after; label maps in {0, 1, 2}, umaps
   in [0, 1], finite outputs (the skew samples' non-finite coordinates
   counted, a reading); views/s over 3 passes, idle share and top device
   rows; the `lung-cont` and `lung` processor lists without error and
   `lung_clinical` on the card equal to the CPU (20 rows, CTR_gt in
   (0, 1)); DSNT-AL on the card against the CPU at 64^2 (label maps of
   the same samples bitwise, `pred` within 8 pixels); DSNT-AL trained at
   the width of [9] on one batch of 32 (a warm-up step, 4 timed steps,
   launches per step and per validation batch, peak memory, 10 steps in
   which the loss falls); K2 at (1200, 65536) bf16 and (3840, 65536) f32
   against f64 and K3 on one view's 750 structure polygons, bitwise, each
   timed beside its bound;
14. the CAMUS source, before the kernels line: `data=camus-cont
   task=dsnt-al` at the serving width of [5] on
   `CamusContourData.from_arrays` over [5]'s films (6 test views), with
   the LV alone (K=21: K2 1, K3 1 per view) and with [BG, LV, MYO] (K=42 in
   two contour groups: K2 1 on 840 heatmaps, K3 2 per view: the samples'
   label maps of both structures in one launch, and mu's), launch counters
   reset just before and read just after; label maps in {0, 1(, 2)}, every
   label painted; views/s over 2 passes, idle share; the `camus-cont`
   processor list on LV+MYO and the `camus` list on the LV, card equal to
   the CPU within PROCESSOR_TOL; LV+MYO on the card against the CPU at
   64^2 (label maps of the same samples bitwise, the LV painted over the
   MYO); LV+MYO DSNT-AL trained at the width of [9] on one batch of 32 (K2
   1 per step on 1344 heatmaps; 8 steps in which the loss falls; a batch
   of the val split K2 1, K3 1);
15. the other backbones, before the kernels line: ENet, DeepLabV3, the
   ResNet regressor and the UNet with residual and attention, each at its
   JSON config's full width (f32): DSNT-AL trained on one batch of 32 at
   256^2 (launches per step: K2 1, the regressor 0), served over [14]'s 6
   LV views at T_e=10 (dropout 0.1 where the config has none) and T_a=25
   (K2 1 per view on f32 (420, 65536), the regressor 0; K3 1), each
   forward at 64^2 at a small depth on the card against the CPU within
   BACKBONE_BAR; mcdropout served on ENet (no K2 or K3); then K2 on one
   LV+MYO view's (840, 65536) bf16 logits and on one DeepLabV3 view's
   (420, 65536) f32 logits against f64, and K3 on one LV+MYO view's 1,000
   structure polygons, bitwise, each timed beside its bound;
16. deep ensembles, bf16 training and the C++ prefetcher, before the
   kernels line: ten members of [5]'s model (each re-initialised from its
   own seed) saved as member_0.ckpt ... member_9.ckpt and served by
   runner.run's eval-only path over [5]'s 6 views with the five
   processors (its test pass on member 0; K2 1 and K3 1 per view and per
   test batch: the DSNT head runs once on all ten members' 420 heatmaps;
   `contour_samples` with T_e=10); the members loaded as the runner loads
   them, with [5]'s bf16 head, served and timed beside [5] (views/s, idle
   share), at V=4 (K2 1, K3 1 per dispatch), each member's logits in the
   ensemble bitwise its own forward's and its mu and cov, in the ensemble
   and in its own forward, within DSNT_BARS of the f64 moments of those
   logits, K2 on one view's
   (420, 65536) bf16 ensemble logits against f64 and K3 on its 500
   contours bitwise, the skew task's ensemble on one view (K3 3);
   `task.train_ensemble=2` through runner.run at [9]'s configuration (one
   epoch per member; the JAX runner's member_0.ckpt and member_1.ckpt;
   every loss finite; the test views predicted at T_e=2 with the five
   processors and no error); `task.model.dtype=bfloat16` through
   runner.run at [9]'s configuration (3 epochs, every loss finite, the
   loss trajectory beside [9]'s, ms/step, images/s, peak memory; K2 1 per
   step on the head's f32 logits, K3 0); K2 on the bf16-trained head's
   (672, 65536) logits cast to bf16 against f64 and the RowMoments bf16
   gradient against f64 autograd within BF16_GRAD_BAR, each timed beside
   its byte bound; one bf16 step on the card and on the CPU at 64²
   against f64 within BF16_STEP_BARS; every training batch of [9] and
   [16] from the g++-built prefetch library of this checkout (a fall-back
   fails), the first epoch in the order the library gives on the host,
   and the trainer's data-wait phase beside [9]'s.

17. several ranks through torch.distributed, before the kernels line:
   two ranks spawned on the card by parallel/distributed.py `spawn` over
   gloo (NCCL refuses two ranks on one GPU), each running (a) three
   data-parallel SGD steps of [9]'s model (8 stages, drop_block,
   augmentation on) on a global batch of 32 256^2 frames, each rank its 16
   rows, against one process on the card (each leaf's update within
   STEP_BARS' grad_leaf of the leaf plus zero_grad of the largest, the
   step losses within 1e-4, both ranks' weights equal); (b) view-parallel
   run_predict of 8 views at [5]'s configuration against one process,
   every output bitwise (rank 0 returns them, rank 1 none); (c) one view
   in the latency mode on a 1 x 2 mesh (predict_sample_parallel=2), split
   as the JAX package splits it: each rank runs its blocks of the
   MC-dropout tail's 20 rows (one block of 10; one process runs both, one
   after another), K2 once on its 210 heatmaps with the whole batch's band
   count, and its T_a share (13 or 12 of 25) through the sampler and K3;
   against one process at the JAX package's latency budgets (LATENCY_BARS)
   and every output bitwise (sha256, the sample masks included); and one
   view of [12]'s mcdropout configuration through SegPredictor on the same
   mesh (its tail split the same way, no K2 or K3), every output bitwise.
   Each rank's K2 and K3 launches are counted per part (at least 1 where
   the part runs them); the tail rows, K2 rows and bands and K3 contours
   of each rank are recorded, printed and checked; K3 is checked and
   timed at one rank's share of a view (260 contours), K2 at one rank's
   (210, 65536) bf16 rows, each beside its bound. (d) more ranks than
   blocks or samples, in this process: the shards of four ranks of [5]'s
   first test view taken one after another (T_e = 10: two tail blocks,
   ranks 2 and 3 none; T_a = 2: ranks 2 and 3 no sample), their tail rows
   and samples concatenated bitwise one process's, the view's generator
   left where one process leaves it, no K2 or K3 launch for an empty
   share. With two cards or more, the same
   over NCCL with one rank per card and views/s on one card against two;
   with one, NCCL initialised at world size 1 and a line saying the
   multi-card run was skipped.
18. the figures and the prediction writer, before the kernels line, on
   [5]'s 6 served views (no new serving): `point_metrics`,
   `instant_metrics`, `calibration`, `clinical_metrics`, `skewness`,
   `plotting` and `prediction_writer` on the card and on the CPU, the
   outcome asserted by what this machine has: without matplotlib,
   `figure_errors` names exactly the five processors that draw, each
   "No module named 'matplotlib'", `clinical_metrics/metric_figures_error`
   names matplotlib and no PNG is written; with it, no figure error and the
   card's PNG names the CPU's; without h5py, `processor_errors` is exactly
   the writer's "No module named 'h5py'" and no predictions.h5; with it,
   no processor error and one group per view; either way every CSV within
   PROCESSOR_TOL of the CPU's and the .npy dicts equal. The dashboards'
   payloads of the CPU run's views prepared on the card and on the CPU from
   the same rows and MC populations: dense splines (one f64
   `contour_spline` call a view) finite and within SPLINE_BAR_PX of the
   CPU's on every sample; every other leaf equal; payload ms per view on
   the card. `val_figure` once on [5]'s model: without
   matplotlib it raises ModuleNotFoundError and launches nothing, with it
   a figure and one K2 launch.
19. the ConvLayer epilogue kernels (ops/conv_epilogue.py ->
   csrc/conv_epilogue.cu), before the kernels line: at each of unet2's 15
   ConvBlocks' plane shapes at batch 32 (the three deepest encoder stages
   with channel dropout at 0.5), the forward and backward kernels and the
   plain f32 chain (conv bias add, dropout, InstanceNorm, LeakyReLU, with
   autograd) on the same f32 inputs, each held to an f64 evaluation of the
   same formula from those inputs on its own side of every kink: y, dx and
   the three parameter gradients, the kernels' error at most
   EPILOGUE_BAR times the plain chain's (or one f32 rounding, the larger);
   each timed (CUDA graphs) beside its byte bound and the plain chain's
   forward and backward; a whole step's 30 layers summed. The kernels'
   launches are counted on the paths that run them ([9], the skew,
   ensemble, bf16, segmentation, JSRT, LV+MYO, backbone and DDP training
   steps, `epilogue_ledger`): in every train step one forward and one
   backward launch per ConvLayer call on the kernel route (30 of each in a
   unet2 step, none in bf16); the kernels line carries each path's
   launches per step and [19]'s times. DeepLabV3's norm chains take the
   same count (`epilogue_ledger` adds its chains on the kernel route and
   the norm tail's launches, [20]).
20. DeepLabV3's norm chains (models/deeplabv3.py -> ops/conv_epilogue.py
   -> csrc/conv_epilogue.cu), before the kernels line: at each plane shape
   of DeepLabV3-ResNet50 at 256^2, batch 32, the three chains: A (conv
   epilogue, ReLU), P (conv epilogue, no activation) and T (the norm
   tail: norm, channel dropout at 0.1 after it, residual add, ReLU), the
   forward and backward kernels and the plain f32 chain with autograd on
   the same f32 inputs, each held to an f64 evaluation from those inputs
   on its own side of every kink (y, the input's and the parameters'
   gradients, and the residual's for T), the kernels' error at most
   EPILOGUE_BAR times the plain chain's (or one f32 rounding); each timed
   (CUDA graphs) beside its byte bound (A and P 8 and 12 bytes an
   element, T 12 and 20) and the plain chain; a whole step's 60 norms
   summed. Then a full-width DeepLabV3's training forward and backward at
   batch 32: one forward and one backward launch per norm (44 conv
   epilogue, 16 norm tail) in every step, and its output, loss and
   gradients beside the op-by-op model's (`chain_route` forced to "plain"),
   printed.
21. the 1x1 convolutions' weight gradient (models/layers.py `Conv`, routed
   by `wgrad_route` -> ops/conv1x1_wgrad.py -> csrc/conv1x1_wgrad.cu),
   before the kernels line: at each 1x1 shape of DeepLabV3-ResNet50 (40 a
   step) and the UNet's head at batch 32, 256^2, the split-K kernel twice
   (the same bits) and the plain f32 version against f64 (relative
   Frobenius error at most WGRAD_BAR), each timed (CUDA graphs) beside its
   bound (operations at 67 TFLOP/s or bytes at 3.35 TB/s, the larger), the
   plain version, and as yardsticks the port never calls: cuDNN's weight
   gradient under its heuristics and under `cudnn.benchmark`, cuDNN's
   data gradient alone, and torch.matmul's batched product and sum; a
   step's 1x1s summed per model. The kernel's launches are counted in
   every `Trainer.train_step` of the training paths (`epilogue_ledger`):
   1 a step in [9]'s flagship run (and none outside its train steps), 40
   in [15]'s DeepLabV3 training, 1 in [16]'s bf16 run (its head's output
   convolution computes in f32, the bf16 trunk takes none); the kernels
   line carries each path's launches a step. Then in one training forward
   and backward, none in an f64 DeepLabV3, a bf16 one and a no_grad
   forward; and the f32 DeepLabV3 step's cuDNN forward and data gradient
   kernels the same names with the route as without it (`wgrad_route`
   forced to "plain"), and its cuDNN weight gradient launches and time
   both ways, printed.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
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
# The skew path ([10]): the serving configuration of [5] with a DSNTSkew
# task (the 8-stage bf16 backbone, its ConfidenceNet in f32, the esn skew
# PSM sampler; `grid` on one view), then the training run of [9] with
# task=dsnt-skew for 2 epochs, the `skewness` processor after its predict,
# and one freeze_seg epoch.
SKEW_PASSES = 3  # timed passes over the test views after the first
SKEW_EPOCHS = 2
SKEW_DIR = Path("outputs") / "chip_smoke_skew"  # git-ignored, removed at the end
SKEW_TRAIN_OVERRIDES = [
    o for o in TRAIN_OVERRIDES
    if not o.startswith(("task=", "trainer.max_epochs=", "trainer.save_every=", "save_path=",
                         "task.psm_path=", "data.results_processors="))
] + ["task=dsnt-skew", f"trainer.max_epochs={SKEW_EPOCHS}",
     f"trainer.save_every={SKEW_EPOCHS}", f"save_path={SKEW_DIR}",
     f"task.psm_path={SKEW_DIR / 'psm.npz'}",
     "data.results_processors=[instant_metrics, skewness]"]
# Launches (K2, K1, K3) per call on the skew path: the skew umap's level
# contours and the mode's mask add two K3 launches to a view's.
SKEW_PER_CALL = {"train step": (1, 0, 0), "val/test batch": (1, 0, 1), "predict view": (1, 0, 3)}

# The sequence samplers, soft masks and view batching ([11]), at the serving
# configuration of [5] (the Gaussian and skew models of [5] and [10]).
SEQ_PASSES = 3  # timed passes over the test views after the first
# The sequence prior is fit on the training views' (ED, ES) pairs: 80
# synthetic patients give 48 training patients, 96 pairs, more than the
# prior's 4K = 84 dimensions (CAMUS's training split holds 500-odd). On the
# 8 pairs of [5]'s 8 patients the prior has rank 7, and the skew sequence
# sampler draws NaN from it, in the JAX package as in the port (ROADMAP
# Queue 3): [11] prints that count as a reading.
SEQ_PRIOR_PATIENTS = 80
SEQ_PER_VIEW = {"gaussian": (1, 0, 1), "skew": (1, 0, 3)}  # (K2, K1, K3) per view
BATCH_VIEWS = 4  # predict_batch_views: 6 views = a dispatch of 4, then one of 2
BATCH_ROUNDS = 2  # timed rounds of passes in turns: V=1, V=4, V=4, V=1
# A view served in a dispatch of V against the same view alone (JAX
# tests/test_parallel.py:278-285): mu and cov absolute (px, px^2), and the
# pred pixels that may differ.
BATCH_BUDGETS = {"mu": 1e-5, "cov": 1e-4, "pred_px": 8}

# K2's gradient against autograd of the plain version in f64, relative to
# the largest gradient: the adjoint recomputes p in f32 (CPU: 1.8e-7).
GRAD_BAR = 1e-5
# One optimizer step, GPU against CPU (f32 convolutions, TF32 off; see
# gpu_vs_cpu_step): per gradient leaf, a share of the leaf's largest f64
# value plus 1e-5 of the largest gradient of all, and each weight within the
# learning rate times that bar plus 2e-7 (f32 rounding of weights of order
# 1). The path as it runs is held to 1e-2 of a leaf of the CPU's: with
# cuDNN's f32 algorithms its weight gradients sat up to 5.5e-3 of their leaf
# from the CPU's, with K2 or with the plain moments alike (PERF.md). The f64
# reference is the model computing in f64 throughout. An f32 forward puts an
# activation within rounding of zero on the other side of a LeakyReLU kink
# now and then, which moves every gradient behind it by ~1e-3 of a leaf
# (the CPU's f32 step: 5.6e-3 of a leaf from f64 on the host of an H100
# machine). So each step's flips against the f64 forward are counted (at
# most `kink_flips`, each within `kink_zero` of zero in f64), and the step
# with cuDNN off is held to `no_cudnn` of the f64 gradients on its own
# forward's side of every kink (`leaky_relu_sides`); K2 to 1e-5 of the
# plain moments on the same convolutions (8.1e-7 measured). The conv biases
# ahead of an instance norm have an exact gradient of 0: theirs is rounding
# noise, held under 1e-3 of the largest gradient.
STEP_BARS = {"grad_leaf": 1e-2, "no_cudnn": 1e-3, "kernel_vs_plain": 1e-5,
             "kink_flips": 16, "kink_zero": 1e-4,
             "grad_all": 1e-5, "param_round": 2e-7, "zero_grad": 1e-3}


# The ConvLayer epilogue kernels ([19]): unet2's 15 ConvBlocks at 256^2
# (channels, plane side, channel dropout), encoder then decoder; two
# ConvLayers each. Each kernel output's error against f64 at most
# EPILOGUE_BAR times the plain f32 chain's, or EPILOGUE_FLOOR (one f32
# rounding) where that is larger.
EPILOGUE_BLOCKS = [(32, 256, False), (64, 128, False), (128, 64, False), (256, 32, False),
                   (480, 16, False), (480, 8, True), (480, 4, True), (480, 2, True),
                   (480, 4, False), (480, 8, False), (480, 16, False), (256, 32, False),
                   (128, 64, False), (64, 128, False), (32, 256, False)]
EPILOGUE_BATCH = 32
UNET2_LAYERS = 2 * (2 * 8 - 1)  # ConvLayers of the 8-stage UNet: 2 per ConvBlock
EPILOGUE_BAR = 2.0
EPILOGUE_FLOOR = 2.0 ** -24

# DeepLabV3-ResNet50's norm chains ([20]) at 256^2: (chain, channels, plane
# side, chains of that shape in a step). A: conv -> norm -> ReLU (the stem,
# each bottleneck's first two, ASPP's five branches and projection, the
# head), P: a stage's projection, conv -> norm; T: a bottleneck's last norm,
# channel dropout at DEEPLAB_DROPOUT, the residual add and the ReLU.
DEEPLAB_CHAINS = [("A", 64, 128, 1), ("A", 64, 64, 6), ("A", 128, 64, 1), ("A", 128, 32, 7),
                  ("A", 256, 32, 1), ("A", 256, 16, 17), ("A", 512, 16, 6), ("A", 256, 1, 1),
                  ("P", 256, 64, 1), ("P", 512, 32, 1), ("P", 1024, 16, 1), ("P", 2048, 16, 1),
                  ("T", 256, 64, 3), ("T", 512, 32, 4), ("T", 1024, 16, 6), ("T", 2048, 16, 3)]
DEEPLAB_NORMS = 60  # 1 + 3 x 16 bottlenecks + 4 projections + 6 in ASPP + 1 in the head
DEEPLAB_DROPOUT = 0.1
# Bytes an element each kernel must move (forward, backward).
CHAIN_BYTES = {"A": (8.0, 12.0), "P": (8.0, 12.0), "T": (12.0, 20.0)}

# The 1x1 convolutions' weight gradient ([21]) at batch 32, 256^2: (model,
# Co, Ci, input side, stride, convolutions of that shape in a step).
# DeepLabV3-ResNet50's 40 (two a bottleneck, four projections, ASPP's 1x1
# branch, pooled branch and projection, the head's output) and the UNet's
# 32 -> 21 head. The kernel's and the plain f32 version's error against
# f64 (Frobenius norm, relative) at most WGRAD_BAR.
WGRAD_1X1 = [("deeplabv3", 64, 64, 64, 1, 1), ("deeplabv3", 256, 64, 64, 1, 4),
             ("deeplabv3", 64, 256, 64, 1, 2), ("deeplabv3", 128, 256, 64, 1, 1),
             ("deeplabv3", 512, 128, 32, 1, 4), ("deeplabv3", 512, 256, 64, 2, 1),
             ("deeplabv3", 128, 512, 32, 1, 3), ("deeplabv3", 256, 512, 32, 1, 1),
             ("deeplabv3", 1024, 256, 16, 1, 6), ("deeplabv3", 1024, 512, 32, 2, 1),
             ("deeplabv3", 256, 1024, 16, 1, 5), ("deeplabv3", 512, 1024, 16, 1, 1),
             ("deeplabv3", 2048, 512, 16, 1, 3), ("deeplabv3", 2048, 1024, 16, 1, 1),
             ("deeplabv3", 512, 2048, 16, 1, 2), ("deeplabv3", 256, 2048, 16, 1, 1),
             ("deeplabv3", 256, 2048, 1, 1, 1), ("deeplabv3", 256, 1280, 16, 1, 1),
             ("deeplabv3", 21, 256, 16, 1, 1), ("unet2", 21, 32, 256, 1, 1)]
WGRAD_BATCH = 32
WGRAD_BAR = 1e-5
DEEPLAB_1X1 = 40  # 2 x 16 bottlenecks + 4 projections + 3 in ASPP + the head's output


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
    mu_k, sig_k = raw6_to_pixel_gaussians(raw[:, :6].double(), height, width)
    return gaussian_errors(mu_k, sig_k, mu_r, sig_r)


def gaussian_errors(mu, sigma, mu_ref, sigma_ref) -> dict:
    """Pixel Gaussians (R, 2), (R, 2, 2) against the f64 reference's: the
    largest mu error (px) and the largest sigma error relative to the
    reference's mean variance of the same row."""
    scale = (sigma_ref[:, 0, 0] + sigma_ref[:, 1, 1])[:, None, None] / 2.0
    return {"mu_px": (mu.double() - mu_ref).abs().max().item(),
            "sigma_rel": ((sigma.double() - sigma_ref).abs() / scale).max().item()}


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


def camus_data(n_patients: int, size: int, seed: int, labels=("BG", "LV")):
    """The `data=synthetic` source: the films the JAX package's
    write_camus_hdf5 writes for these arguments, read from memory by
    CamusContourData, the landmarks extracted from the label masks."""
    from contouring_uncertainty_torch.data.config import Label
    from contouring_uncertainty_torch.data.synthetic import synthetic_camus_data

    return synthetic_camus_data(n_patients, size, seed,
                                labels=tuple(Label[name] for name in labels))


def main_path(profile_dir=None) -> dict:
    """run_predict on the flagship serving configuration."""
    import torch

    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel
    from contouring_uncertainty_torch.predict import run_predict
    from contouring_uncertainty_torch.tasks import DSNTAleatoric

    c = MAIN_CFG
    t0 = time.perf_counter()
    data = camus_data(c["n_patients"], c["size"], c["seed"])
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

    check_gaussian_results(results)

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


def check_gaussian_results(results, t_e: int = MAIN_CFG["t_e"]) -> None:
    """The JAX package's shapes at MAIN_CFG (T_e samples per frame),
    finite values, a painted sample mask and uncertainty map."""
    c = MAIN_CFG
    n, t_a, k, s = 2, c["t_a"], c["k"], c["size"]
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
    predict dispatch (one view, or V views with `predict_batch_views`), the
    (K2, K1, K3) launches it made; the class methods are wrapped while the
    block runs."""
    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel
    from contouring_uncertainty_torch.predict import AleatoricPredictor
    from contouring_uncertainty_torch.tasks import DSNTAleatoric
    from contouring_uncertainty_torch.train import Trainer

    def counts():
        return (dsnt_kernel.row_launches, dsnt_kernel.col_launches, select_kernel.launches)

    ledger = {"train step": [], "val/test batch": [], "predict view": []}
    targets = [(Trainer, "train_step", "train step"),
               (DSNTAleatoric, "val_metrics", "val/test batch"),
               (AleatoricPredictor, "batched", "predict view")]
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


def norm_launches():
    """(forward, backward) launches of the norm chain kernels so far: the
    conv epilogue's and the norm tail's."""
    from contouring_uncertainty_torch.ops import conv_epilogue as ce

    return (ce.fwd_launches + ce.tail_fwd_launches, ce.bwd_launches + ce.tail_bwd_launches)


def wgrad_launches():
    """(kernel, reduce pass) launches of the 1x1 weight gradient so far."""
    from contouring_uncertainty_torch.ops import conv1x1_wgrad as cw

    return cw.launches, cw.reduce_launches


def zero_wgrad_launches() -> None:
    from contouring_uncertainty_torch.ops import conv1x1_wgrad as cw

    cw.launches = cw.reduce_launches = 0


@contextmanager
def routed_chains():
    """While the block runs, the norm chains taking the kernel route (the
    UNet's ConvLayers, DeepLabV3's chains): models/layers.py `chain_route`'s
    "kernel" answers. Yields a one-element list, the count so far."""
    from contouring_uncertainty_torch.models import layers

    routed = [0]
    route_fn = layers.chain_route

    def chain_route(*args):
        route = route_fn(*args)
        routed[0] += route == "kernel"
        return route

    layers.chain_route = chain_route
    try:
        yield routed
    finally:
        layers.chain_route = route_fn


@contextmanager
def epilogue_ledger():
    """Per train step (`Trainer.train_step`, wrapped while the block runs):
    the norm chain kernels' (forward, backward) launches (`norm_launches`),
    the chains on the kernel route (`routed_chains`) and the 1x1 weight
    gradient's (kernel, reduce pass) launches (`wgrad_launches`) in it."""
    from contouring_uncertainty_torch.train import Trainer

    steps = []
    step_fn = Trainer.train_step

    def train_step(self, *args, **kwargs):
        before, wgrad_before, routed[0] = norm_launches(), wgrad_launches(), 0
        out = step_fn(self, *args, **kwargs)
        after, wgrad_after = norm_launches(), wgrad_launches()
        steps.append((after[0] - before[0], after[1] - before[1], routed[0],
                      wgrad_after[0] - wgrad_before[0], wgrad_after[1] - wgrad_before[1]))
        return out

    Trainer.train_step = train_step
    try:
        with routed_chains() as routed:
            yield steps
    finally:
        Trainer.train_step = step_fn


def epilogue_per_step(label: str, steps: list, layers=None, wgrad=None) -> dict:
    """From `epilogue_ledger`'s steps: every step launched the forward and
    the backward kernel once per ConvLayer call on the kernel route (and
    made `layers` such calls, where given) and the 1x1 weight gradient
    kernel `wgrad` times (where given), the same in every step ->
    launches per step."""
    norm = [step[:3] for step in steps]
    want = None if layers is None else (layers, layers, layers)
    if not steps or len(set(norm)) != 1 or norm[0][0] != norm[0][2] \
            or norm[0][1] != norm[0][2] or want not in (None, norm[0]):
        raise AssertionError(f"{label}: conv epilogue launches (forward, backward, ConvLayer "
                             f"calls on the kernel route) per train step {sorted(set(norm))}, "
                             f"expected one launch of each per call"
                             f"{'' if want is None else f', {layers} calls'}")
    per_step = {step[3:] for step in steps}
    if len(per_step) != 1 or wgrad not in (None, steps[0][3]):
        raise AssertionError(f"{label}: 1x1 weight gradient launches (kernel, reduce pass) per "
                             f"train step {sorted(per_step)}, expected the same in every step"
                             f"{'' if wgrad is None else f', {wgrad} kernel launches'}")
    return {"forward": steps[0][0], "backward": steps[0][1], "wgrad": steps[0][3],
            "wgrad_reduce": steps[0][4], "steps": len(steps)}


def training_run() -> dict:
    """runner.run at the flagship training configuration, launches counted."""
    import torch

    from contouring_uncertainty_torch import runner
    from contouring_uncertainty_torch.data import native_loader
    from contouring_uncertainty_torch.ops import conv_epilogue as ce
    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dsnt_kernel.row_launches = dsnt_kernel.col_launches = 0
    select_kernel.launches = 0
    ce.fwd_launches = ce.bwd_launches = 0
    zero_wgrad_launches()
    native_loader.batches_served = 0
    t0 = time.perf_counter()
    with launch_ledger() as ledger, epilogue_ledger() as epi:
        result = runner.run(TRAIN_OVERRIDES)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    feed = native_feed(len(ledger["train step"]))
    totals = {"K2": dsnt_kernel.row_launches, "K1": dsnt_kernel.col_launches,
              "K3": select_kernel.launches}
    epilogue = {**epilogue_per_step("[9] training", epi, layers=UNET2_LAYERS, wgrad=1),
                "run_forward": ce.fwd_launches, "run_backward": ce.bwd_launches,
                "run_wgrad": wgrad_launches()[0]}
    if epilogue["run_wgrad"] != epilogue["wgrad"] * epilogue["steps"]:
        raise AssertionError(f"[9] training: {epilogue['run_wgrad']} 1x1 weight gradient "
                             f"launches in the run, {epilogue['wgrad']} in each of its "
                             f"{epilogue['steps']} train steps and none elsewhere expected")
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
            "per_call": expected, "totals": totals, "epilogue": epilogue, "peak_gib": peak_gib,
            "step_ms": median_ms, "step_ms_range": (later[0], later[-1]),
            "first_step_ms": steps[0], "images_per_s": TRAIN_CFG["batch"] / median_ms * 1e3,
            "eval_ms": phases.get("eval_step", {}).get("median_ms"), "feed": feed,
            "data_wait": data_wait(phases),
            "losses": [row["train/loss"] for row in history]}


def native_feed(steps: int) -> dict:
    """Every one of a run's `steps` training batches came from the g++-built
    prefetch library of this checkout's source in _build/ (the counter of
    data/native_loader.py, reset before the run); a run fed by the numpy
    fall-back fails."""
    from contouring_uncertainty_torch import build
    from contouring_uncertainty_torch.data import native_loader

    lib = native_loader.library_file
    want = build.host_library_path("prefetch_loader")
    if lib is None or lib != want or not lib.exists():
        raise AssertionError(f"the prefetch library is {lib}, not {want}: the fall-back fed "
                             "the training run")
    if native_loader.batches_served != steps:
        raise AssertionError(f"{native_loader.batches_served} batches from the prefetch "
                             f"library for {steps} train steps")
    return {"library": str(lib.relative_to(build.PACKAGE_DIR.parent)), "batches": steps}


def data_wait(phases: dict) -> dict:
    """The trainer's `data` phase (the wait for each next batch) from its
    phases JSON: median and total ms."""
    d = phases["data"]
    return {"median_ms": d["median_ms"], "total_ms": round(1e3 * d["total_s"], 1),
            "count": d["count"]}


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
    swapped for the plain moments, cuDNN off, and both. The f64 reference
    is the same model computing in f64 throughout (`set_compute_dtype`),
    also pinned to each step's LeakyReLU sides (`leaky_relu_sides`).
    Gates (STEP_BARS, per gradient leaf, relative to its largest f64
    value): the path within `grad_leaf` of the CPU and its weights within lr
    times that; K2 against the plain moments with cuDNN off (the same
    deterministic convolutions) within `kernel_vs_plain`; the CPU's and the
    no-cuDNN step's kink flips against the f64 forward; K2 with cuDNN off
    within `no_cudnn` of the f64 gradients pinned to its sides.
    SGD, not the slice's AdamW: AdamW's first step is lr * sign(g) wherever
    |g| >> eps, so on the biases whose gradient is rounding noise of either
    sign it sets the two devices' weights 2 lr apart; SGD keeps the update
    proportional to the gradient."""
    import torch

    from contouring_uncertainty_torch.data.config import DataParams, Tags
    from contouring_uncertainty_torch.data.synthetic import make_arrays
    from contouring_uncertainty_torch.models.layers import set_compute_dtype
    from contouring_uncertainty_torch.models.unet import leaky_relu_sides
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
        with leaky_relu_sides(trainer.model) as sides:
            loss = float(trainer.train_step(batch_on(device), 0)["loss"])
        return loss, {n: (p.grad.detach().cpu().double(), p.detach().cpu())
                      for n, p in trainer.model.named_parameters()}, \
            {n: s.cpu() for n, s in sides.items()}

    def f64_step(pin=None):
        """The f64 model's gradients, its LeakyReLU sides and inputs."""
        model64 = set_compute_dtype(task.build_model(
            device="cpu", generator=torch.Generator().manual_seed(cfg.seed)).double(),
            torch.float64)
        pre = {}
        for name, mod in model64.named_modules():
            if name.endswith(".InstanceNorm_0"):
                layer = name[:-len(".InstanceNorm_0")]
                mod.register_forward_hook(
                    lambda m, i, y, layer=layer: pre.update({layer: y.detach()}))
        with leaky_relu_sides(model64, pin) as sides:
            task.loss(model64, batch_on("cpu", torch.float64), train=True)[0].backward()
        return {n: p.grad for n, p in model64.named_parameters()}, sides, pre

    out = {"cpu": one_step("cpu")}
    for variant, flags in STEP_VARIANTS.items():
        with step_variant(*flags):
            out[variant] = one_step("cuda")
    ref, sides64, pre64 = f64_step()
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
    flips, pinned = {}, {}
    for k, o in out.items():
        flipped = {n: o[2][n] != sides64[n] for n in sides64}
        flips[k] = (sum(int(f.sum()) for f in flipped.values()),
                    max((float(pre64[n][f].abs().max()) for n, f in flipped.items() if f.any()),
                        default=0.0))
        pinned[k] = f64_step(o[2])[0]
    readings = {f"{k} vs f64": worst(o[1], ref) for k, o in out.items()}
    readings.update({f"{k} vs f64 on its kink sides": worst(o[1], pinned[k])
                     for k, o in out.items()})
    readings["K2 vs plain moments, no cuDNN"] = worst(out["no cuDNN"][1],
                                                      grads["plain moments, no cuDNN"])
    readings["K2 vs plain moments, cuDNN"] = worst(out["path"][1], grads["plain moments"])
    readings["path vs cpu"] = worst(out["path"][1], grads["cpu"])
    for label, (ratio, name) in readings.items():
        print(f"      {label:50s} {ratio:.3e} of a leaf's largest ({name})")
    n_act = sum(s.numel() for s in sides64.values())
    for k, (n, near) in flips.items():
        print(f"      {k:50s} {n} of {n_act} activations on the other side of a kink "
              f"from f64, the farthest {near:.2e} from zero in f64")
    zero_noise = max(float(g[n].abs().max()) for g in grads.values() for n in zero) / grad_all

    def of_bar(a, against, leaf_bar):
        """Worst |a - against| per leaf as a share of leaf_bar * leaf max
        plus grad_all * the largest gradient of all."""
        return max(float((grads[a][n] - against[n]).abs().max())
                   / (leaf_bar * float(ref[n].abs().max()) + STEP_BARS["grad_all"] * grad_all)
                   for n in leaves)

    grad_bar = {n: STEP_BARS["grad_leaf"] * float(ref[n].abs().max())
                + STEP_BARS["grad_all"] * grad_all for n in leaves}
    param = max(float((out["path"][1][n][1] - out["cpu"][1][n][1]).abs().max())
                / (cfg.lr * grad_bar[n] + STEP_BARS["param_round"]) for n in leaves)
    gates = {"path vs cpu": of_bar("path", grads["cpu"], STEP_BARS["grad_leaf"]),
             "path weights vs cpu": param,
             "K2 vs plain moments, no cuDNN": of_bar("no cuDNN", grads["plain moments, no cuDNN"],
                                                     STEP_BARS["kernel_vs_plain"]),
             "no cuDNN vs f64 on its kink sides": of_bar("no cuDNN", pinned["no cuDNN"],
                                                         STEP_BARS["no_cudnn"]),
             "zero-gradient biases": zero_noise / STEP_BARS["zero_grad"]}
    for k in ("cpu", "no cuDNN"):
        gates[f"{k} kink flips"] = max(flips[k][0] / STEP_BARS["kink_flips"],
                                       flips[k][1] / STEP_BARS["kink_zero"])
    loss_err = abs(out["path"][0] - out["cpu"][0])
    if max(gates.values()) > 1.0:
        raise AssertionError(f"GPU step outside its bars: {gates} (shares of the bars "
                             f"{STEP_BARS})")
    return {"of_bar": gates, "readings": {k: v[0] for k, v in readings.items()},
            "flips": flips, "loss_abs": loss_err, "loss": out["cpu"][0]}


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


class FirstViews:
    """A data source's first `n` test views alone (its training contours
    kept)."""

    def __init__(self, data, n: int = 1):
        self.data, self.n = data, n
        self.data_params = data.data_params
        self.contour_groups = data.contour_groups

    def predict_views(self, split="test"):
        views = iter(self.data.predict_views(split))
        for _ in range(self.n):
            yield next(views)

    def train_arrays(self, split="train"):
        return self.data.train_arrays(split)


def skew_serving(profile_dir=None) -> dict:
    """run_predict with a DSNTSkew task at the flagship serving width: esn
    over the test views (launches counted per view, then steady-state
    passes and a profiled pass), then `grid` on one view."""
    import torch

    from contouring_uncertainty_torch.predict import run_predict
    from contouring_uncertainty_torch.tasks import DSNTSkew

    c = MAIN_CFG
    data = camus_data(c["n_patients"], c["size"], c["seed"])
    task = DSNTSkew(data_params=data.data_params, t_e=c["t_e"], t_a=c["t_a"],
                    model_kwargs=dict(drop_block=True, dtype="bfloat16", head_dtype="bfloat16"))
    model = task.build_model(device="cuda", generator=torch.Generator().manual_seed(c["seed"]))
    if model.confidence_net.Dense_0.weight.dtype != torch.float32:
        raise AssertionError("the ConfidenceNet is not f32")
    cfg = {"seed": c["seed"], "task": {"skew_method": "esn", "grid_window": 64}}

    run = serve(task, model, data, cfg, SKEW_PASSES,
                profile_dir / "skew" if profile_dir is not None else None)
    results, n_views, launches = run["results"], run["views"], run["launches"]
    per_view = run["per_dispatch"]
    if len(per_view) != n_views or any(v != SKEW_PER_CALL["predict view"] for v in per_view):
        raise AssertionError(f"skew serving launches (K2, K1, K3) per view {per_view}, expected "
                             f"{SKEW_PER_CALL['predict view']}")
    if launches != {"K2": n_views, "K1": 0, "K3": 3 * n_views}:
        raise AssertionError(f"skew serving launched {launches} in {n_views} views")
    check_skew_results(results, c["t_e"], c["t_a"], c["size"])

    one = FirstViews(data)
    grid_cfg = {"seed": c["seed"], "task": {"skew_method": "grid", "grid_window": 64}}
    grid = run_predict(task, model, one, grid_cfg, split="test")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = run_predict(task, model, one, grid_cfg, split="test")
    torch.cuda.synchronize()
    grid_ms = (time.perf_counter() - t0) * 1e3
    check_skew_results(grid, c["t_e"], c["t_a"], c["size"])
    return {**run, **rate(run, run["pass_s"]), "grid_ms": grid_ms, "task": task, "model": model,
            "data": data}


def check_skew_results(results, t_e: int, t_a: int, size: int) -> None:
    """The JAX package's shapes, finite values, a painted map, and the
    prediction = the mode's mask."""
    n, k = 2, MAIN_CFG["k"]
    shapes = {"mu": (n, k, 2), "cov": (n, k, 2, 2), "alpha": (n, k, 2), "mode": (n, k, 2),
              "post_mu": (n, k, 2), "post_cov": (n, k, 2, 2),
              "contour_samples": (n, t_e, t_a, k, 2), "pred_samples": (n, t_e, t_a, size, size),
              "pred": (n, size, size), "uncertainty_map": (n, size, size),
              "entropy_map": (n, size, size)}
    for res in results:
        for key, shape in shapes.items():
            value = getattr(res, key)
            if value is None or value.shape != shape:
                raise AssertionError(f"skew {key} shape {getattr(value, 'shape', None)} != {shape}")
            if not np.isfinite(value.astype(np.float64)).all():
                raise AssertionError(f"skew {key} has non-finite values")
        for group in (res.point_uncertainty, res.instant_uncertainty):
            for key, value in group.items():
                if not np.isfinite(value).all():
                    raise AssertionError(f"skew {key} has non-finite values")
        if res.uncertainty_map.max() <= 0 or res.pred.max() != 1 or np.array_equal(res.mode, res.mu):
            raise AssertionError("skew view: no map painted, no mode mask, or mode == mu")


def numbers_only(metrics: dict) -> dict:
    """A processors' summary without `figure_errors`, which may name only a
    missing matplotlib, and only where this machine lacks it ([18] asserts
    the whole outcome)."""
    import importlib.util

    errors = metrics.get("figure_errors", {})
    if errors and (importlib.util.find_spec("matplotlib") is not None
                   or any("'matplotlib'" not in e for e in errors.values())):
        raise AssertionError(f"figure errors: {errors}")
    return {k: v for k, v in metrics.items() if k != "figure_errors"}


def skew_processor_check(results) -> dict:
    """The skewness processor on the served views, run from the card's
    entry point and from the CPU's: the same numbers and skewness.npy."""
    import tempfile

    from contouring_uncertainty_torch.results import run_processors

    cfg = {"data": {"results_processors": ["skewness"]}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        gpu = run_processors(results, tmp / "gpu", cfg, device="cuda")
        host_ms = (time.perf_counter() - t0) * 1e3 / len(results)
        cpu = run_processors(results, tmp / "cpu", cfg, device="cpu")
        saved = [np.load(tmp / d / "skewness.npy", allow_pickle=True).item() for d in ("gpu", "cpu")]
    gpu, cpu = numbers_only(gpu), numbers_only(cpu)
    if "processor_errors" in gpu or gpu != cpu or set(gpu) != {
            "skewness/error_skew_x", "skewness/error_skew_y", "skewness/mean_alpha_norm"}:
        raise AssertionError(f"skewness processor: card {gpu}, CPU {cpu}")
    if not all(np.array_equal(saved[0][k], saved[1][k]) for k in ("errors", "average_skew")):
        raise AssertionError("skewness.npy differs between the card and the CPU")
    if not all(np.isfinite(v) for v in gpu.values()):
        raise AssertionError(f"skewness processor numbers not finite: {gpu}")
    return {**gpu, "host_ms_per_view": host_ms}


def skew_kernel_checks(serve: dict) -> dict:
    """K3 against its plain version on one view's 400 skew-umap level
    contours (bitwise, NaN positions matched, fills equal), timed beside
    its bound; K2 against f64 on the skew model's bf16 head logits of one
    view (T_e x N = 420 heatmaps)."""
    import torch

    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel
    from contouring_uncertainty_torch.ops.rasterize import fill_from_crossings
    from contouring_uncertainty_torch.ops.spline import contour_spline
    from contouring_uncertainty_torch.utils.umap import skew_level_contours

    c = MAIN_CFG
    size = c["size"]
    res = serve["results"][0]
    mu, cov, alpha = (torch.as_tensor(getattr(res, k), device="cuda") for k in ("mu", "cov", "alpha"))
    _, contours, _ = skew_level_contours(mu, cov, alpha)
    dense = contour_spline(contours.reshape(-1, c["k"], 2), n=1024).contiguous()
    check_selection(dense, size, size, f"skew umap level contours ({dense.shape[0]})")
    xs = select_kernel.min_k_crossings_kernel(dense, size)
    areas = fill_from_crossings(xs, dense, size).sum(dim=(-2, -1))
    # The innermost levels hug the mode: their plus and minus crossings
    # nearly meet.
    narrow = int((areas < 0.05 * areas.max()).sum().item())
    k3_ms = cuda_ms(lambda: select_kernel.min_k_crossings_kernel(dense, size))
    k3_plain = cuda_ms(lambda: select_kernel.min_k_crossings_plain(dense, size), iters=5)
    neg_cand = -select_kernel.crossing_candidates(dense, size)
    n_cross = int(torch.isfinite(neg_cand).sum().item())
    k3_lib = cuda_ms(lambda: torch.topk(neg_cand, 16, dim=-1), iters=5)
    del neg_cand
    m, e, _ = dense.shape
    k3_bound = {"bytes": (m * e * 2 * 4 + m * size * 16 * 4) / HBM_BYTES_PER_S * 1e3,
                "operations": (4 * m * e + 6 * n_cross) / F32_OPS_PER_S * 1e3}

    view = next(iter(serve["data"].predict_views("test")))
    img = torch.as_tensor(view["img"], device="cuda")
    with torch.inference_mode():
        logits = serve["model"](img.repeat(c["t_e"], 1, 1, 1), deterministic=False,
                                generator=torch.Generator().manual_seed(1))["out"]
    rows = logits.reshape(-1, size * size)
    raw = dsnt_kernel.raw_moments_cuda(rows, size, size)
    ref = dsnt_kernel.raw_moments_plain(rows.double(), size, size)
    err = moment_errors(raw, ref, size, size)
    print(f"    K2 on the skew head's logits ({rows.shape[0]} rows {rows.dtype}): mu err "
          f"{err['mu_px']:.3e} px, sigma rel err {err['sigma_rel']:.3e}")
    if not within_dsnt_bars(err):
        raise AssertionError(f"K2 on the skew head's logits outside {DSNT_BARS}: {err}")
    return {"level_contours": m, "narrow_levels": narrow, "min_area_px": int(areas.min().item()),
            "k3_ms": k3_ms, "k3_plain_ms": k3_plain, "k3_library_ms": k3_lib,
            "k3_bound_ms": max(k3_bound.values()), "k3_bound_by": max(k3_bound, key=k3_bound.get),
            "k2_err": err, "k2_max_abs_err": (raw.double() - ref).abs().max().item()}


def skew_reference_check() -> dict:
    """The skew predictor on the GPU (kernels) against the CPU (plain
    versions) on one small view, the same weights and CPU-generator draws:
    mu, cov, alpha, the projected mode and the skew umap."""
    import torch

    from contouring_uncertainty_torch.data.config import DataParams
    from contouring_uncertainty_torch.data.synthetic import make_arrays
    from contouring_uncertainty_torch.predict import AleatoricPredictor, view_generator
    from contouring_uncertainty_torch.sampler import SkewPosteriorShapeModelSampler, fit_shape_prior
    from contouring_uncertainty_torch.tasks import DSNTSkew
    from contouring_uncertainty_torch.utils.projection import projected_uncertainty
    from contouring_uncertainty_torch.utils.umap import skew_umap

    imgs, _, contours = make_arrays(12, size=64, seed=1)
    task = DSNTSkew(
        data_params=DataParams(in_shape=(1, 64, 64), out_shape=(21, 2)), t_e=2, t_a=8,
        model_kwargs=dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3,
                          drop_block=True))
    prior = fit_shape_prior(contours)
    outs = {}
    for device in ("cpu", "cuda"):
        model = task.build_model(device=device, generator=torch.Generator().manual_seed(3))
        sampler = SkewPosteriorShapeModelSampler(prior, image_extent=63.0, device=device)
        predictor = AleatoricPredictor(task, model, sampler, device=device)
        outs[device] = {k: v.cpu() for k, v in predictor(imgs[:2], view_generator(5, 0)).items()
                        if isinstance(v, torch.Tensor)}
    cpu, gpu = outs["cpu"], outs["cuda"]
    rel = {k: ((gpu[k] - cpu[k]).abs().max() / cpu[k].abs().max()).item()
           for k in ("cov", "alpha")}
    mu_err = (gpu["mu"] - cpu["mu"]).abs().max().item()
    u, _, _ = projected_uncertainty(cpu["mu"], cpu["cov"], cpu["alpha"])

    def compare(mode_g, umap_g, mode_c, umap_c):
        steps = ((mode_g.cpu() - mode_c).norm(dim=-1) / (6.0 * u / 1000)).max().item()
        return steps, ((umap_g.cpu() - umap_c).abs() > 1e-5).float().mean().item()

    path = compare(gpu["mode"], gpu["uncertainty_map"], cpu["mode"], cpu["uncertainty_map"])
    # The same (CPU) mu, cov and alpha through skew_umap on the card isolate
    # it from the forward's rounding.
    same = compare(*skew_umap(cpu["mu"].cuda(), cpu["cov"].cuda(), cpu["alpha"].cuda(),
                              (64, 64)), cpu["mode"], cpu["uncertainty_map"])
    print(f"    skew GPU vs CPU (64^2, 4-stage f32, T_e=2, T_a=8): mu {mu_err:.2e} px, cov rel "
          f"{rel['cov']:.2e}, alpha rel {rel['alpha']:.2e}; mode {path[0]:.2f} profile steps, "
          f"umap pixels differing > 1e-5: {path[1]:.2e}; skew_umap on the CPU's mu, cov and "
          f"alpha: mode {same[0]:.2f} steps, umap pixels differing {same[1]:.2e}")
    # mu, cov and alpha: f32 convolutions reduce in another order on the
    # card (~1e-6). The mode is a first argmax on a 1000-step profile (one
    # step allowed); the umap averages 400 masks, and a level contour whose
    # vertices move by that 1e-6 flips the boundary pixels of its mask: on
    # the path 2% of the pixels are allowed (0.57% measured on an H100
    # 80GB HBM3), on the same inputs 0.5%, as in the CPU parity tests.
    if (mu_err > 1e-3 or max(rel.values()) > 1e-3 or max(path[0], same[0]) > 1.0
            or path[1] > 2e-2 or same[1] > 5e-3):
        raise AssertionError("the skew GPU path disagrees with the CPU path")
    return {"mu_px": mu_err, **rel, "mode_steps": path[0], "umap_pixels": path[1],
            "same_input_mode_steps": same[0], "same_input_umap_pixels": same[1]}


def skew_training() -> dict:
    """runner.run with task=dsnt-skew at the flagship training width
    (launches per call counted), then one freeze_seg epoch, whose
    checkpoint must hold the seed's backbone bitwise."""
    import torch

    from contouring_uncertainty_torch import runner
    from contouring_uncertainty_torch.config import compose
    from contouring_uncertainty_torch.data.config import DataParams
    from contouring_uncertainty_torch.factory import build_task
    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel
    from contouring_uncertainty_torch.train.checkpoint import restore_checkpoint

    shutil.rmtree(SKEW_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dsnt_kernel.row_launches = dsnt_kernel.col_launches = 0
    select_kernel.launches = 0
    t0 = time.perf_counter()
    with launch_ledger() as ledger, epilogue_ledger() as epi:
        result = runner.run(SKEW_TRAIN_OVERRIDES)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    totals = {"K2": dsnt_kernel.row_launches, "K1": dsnt_kernel.col_launches,
              "K3": select_kernel.launches}
    epilogue = epilogue_per_step("skew training", epi)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    history = result["history"]
    if len(history) != SKEW_EPOCHS:
        raise AssertionError(f"skew training ran {len(history)} epochs")
    for row in history:
        bad = {k: v for k, v in row.items() if not np.isfinite(v)}
        if bad or "train/loss_term3" not in row or "val/alpha_norm" not in row:
            raise AssertionError(f"skew training log at epoch {row['epoch']}: {row}")
    if "test_error" in result or not all(np.isfinite(v) for v in result["test_metrics"].values()):
        raise AssertionError(f"skew test pass failed: {result.get('test_error')}")
    if "processor_errors" in result:
        raise AssertionError(f"skew processor errors: {result['processor_errors']}")
    for label, calls in ledger.items():
        if not calls or any(c != SKEW_PER_CALL[label] for c in calls):
            raise AssertionError(f"skew launches (K2, K1, K3) per {label}: {calls}, expected "
                                 f"{SKEW_PER_CALL[label]}")
    summed = [sum(c[i] for calls in ledger.values() for c in calls) for i in range(3)]
    if summed != [totals["K2"], totals["K1"], totals["K3"]]:
        raise AssertionError(f"skew launches outside the counted calls: {totals}, {summed}")
    for res in result["predict"]:
        if res.alpha is None or res.mode.shape != res.mu.shape or not np.isfinite(res.mode).all():
            raise AssertionError("skew predict output without alpha or a finite mode")
    name = Path(result["ckpt_path"]).name[:-len(".ckpt")]
    phases = json.loads((Path(result["ckpt_path"]).parent / f"{name}_phases.json").read_text())
    steps = phases["train_step"]["samples_ms"]
    later = sorted(steps[len(steps) // SKEW_EPOCHS:])

    freeze = runner.run(SKEW_TRAIN_OVERRIDES + [
        "task.freeze_seg=true", "trainer.max_epochs=1", "trainer.save_every=1", "test=false",
        "predict=false", f"save_path={SKEW_DIR / 'freeze'}"])
    cfg = compose(SKEW_TRAIN_OVERRIDES)
    size = cfg["data"]["image_size"]
    task = build_task(cfg, DataParams(in_shape=(1, size, size), out_shape=(21, 2)))
    init = task.build_model(generator=torch.Generator().manual_seed(cfg["seed"])).state_dict()
    params = restore_checkpoint(freeze["ckpt_path"], map_location="cuda")["params"]
    unet = [k for k in init if k.startswith("unet.")]
    head = [k for k in init if k.startswith("confidence_net.")]
    changed_unet = [k for k in unet if not torch.equal(params[k], init[k])]
    moved_head = [k for k in head if not torch.equal(params[k], init[k])]
    if changed_unet or len(moved_head) != len(head):
        raise AssertionError(f"freeze_seg: backbone tensors changed {changed_unet[:5]}, head "
                             f"tensors moved {len(moved_head)} of {len(head)}")
    shutil.rmtree(SKEW_DIR, ignore_errors=True)
    return {"history": history, "test": result["test_metrics"], "wall_s": wall_s,
            "views": len(result["predict"]), "totals": totals, "epilogue": epilogue,
            "peak_gib": peak_gib,
            "ledger": {label: len(calls) for label, calls in ledger.items()},
            "step_ms": later[len(later) // 2], "step_ms_range": (later[0], later[-1]),
            "first_step_ms": steps[0], "images_per_s": TRAIN_CFG["batch"] / later[len(later) // 2] * 1e3,
            "eval_ms": phases.get("eval_step", {}).get("median_ms"),
            "freeze": {"unet_tensors": len(unet), "head_tensors": len(head),
                       "val_loss": freeze["history"][-1]["val/loss"]}}


def serve(task, model, data, cfg, passes: int, profile_dir=None,
          profile_views=None) -> dict:
    """run_predict over the test views: launch counters reset just before
    the first run and read just after (per dispatch, by launch_ledger),
    then `passes` timed steady-state passes and a profiled one (over the
    first `profile_views` views only, when given)."""
    import torch

    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel
    from contouring_uncertainty_torch.predict import run_predict

    dsnt_kernel.row_launches = dsnt_kernel.col_launches = 0
    select_kernel.launches = 0
    t0 = time.perf_counter()
    with launch_ledger() as ledger:
        results = run_predict(task, model, data, cfg, split="test")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"K2": dsnt_kernel.row_launches, "K1": dsnt_kernel.col_launches,
                "K3": select_kernel.launches}
    pass_s = [timed_pass(task, model, data, cfg) for _ in range(passes)]
    n = len(results)
    profiled = FirstViews(data, profile_views) if profile_views else data
    t0 = time.perf_counter()
    kernel_ms, copy_ms, table = profile_run(
        lambda: run_predict(task, model, profiled, cfg, split="test"), profile_dir)
    return {"results": results, "views": n, "first_s": first_s, "launches": launches,
            "profile_s": time.perf_counter() - t0,
            "per_dispatch": ledger["predict view"], "pass_s": pass_s,
            "kernel_ms_per_view": kernel_ms / (profile_views or n),
            "copy_ms_per_view": copy_ms / (profile_views or n), "profile": table}


def timed_pass(task, model, data, cfg) -> float:
    """Seconds of one synchronised run_predict over the test views."""
    import torch

    from contouring_uncertainty_torch.predict import run_predict

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_predict(task, model, data, cfg, split="test")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def rate(run: dict, pass_s) -> dict:
    """Median views/s and ms/view over timed passes, with the range and the
    idle share of the profiled pass."""
    ms = sorted(1e3 * t / run["views"] for t in pass_s)
    median = ms[len(ms) // 2]
    busy = (run["kernel_ms_per_view"] + run["copy_ms_per_view"]) / median
    return {"views_per_s": 1e3 / median, "ms_per_view": median, "ms_range": (ms[0], ms[-1]),
            "idle_share": 1.0 - busy}


class TrainedOn:
    """The test views of one data source with the training split of
    another (the priors are fit on the training split)."""

    def __init__(self, views, train):
        self.views, self.train = views, train
        self.data_params = views.data_params
        self.contour_groups = views.contour_groups

    def predict_views(self, split="test"):
        return (self.train if split == "train" else self.views).predict_views(split)

    def train_arrays(self, split="train"):
        return self.train.train_arrays(split)


def sequence_serving(main_res: dict, skew: dict, profile_dir=None) -> dict:
    """run_predict with task.sequence_sampler on the models of [5] and [10],
    over [5]'s 6 test views with the priors fit on SEQ_PRIOR_PATIENTS
    patients' training split: launches per view, shapes, views/s; the same
    models without the sequence sampler (same views, same priors) are timed
    beside them in the same call. Then the skew sequence sampler's NaN count
    on one view's predictions with the sequence prior of [5]'s 8 patients
    (a reading: the reference's fault, ROADMAP Queue 3)."""
    import torch

    from contouring_uncertainty_torch.predict import (
        get_or_fit_prior,
        get_or_fit_sequence_prior,
        view_generator,
    )
    from contouring_uncertainty_torch.sampler import SequenceSkewPSMSampler

    c = MAIN_CFG
    t0 = time.perf_counter()
    data = TrainedOn(main_res["data"], camus_data(SEQ_PRIOR_PATIENTS, c["size"], c["seed"] + 1))
    out = {"data_s": time.perf_counter() - t0}
    for name, base, extra in (("gaussian", main_res, {}),
                              ("skew", skew, {"skew_method": "esn", "grid_window": 64})):
        cfg = {"seed": MAIN_CFG["seed"], "task": {"sequence_sampler": True, **extra}}
        run = serve(base["task"], base["model"], data, cfg, SEQ_PASSES,
                    profile_dir / f"sequence_{name}" if profile_dir is not None else None)
        n = run["views"]
        expected = SEQ_PER_VIEW[name]
        if len(run["per_dispatch"]) != n or any(v != expected for v in run["per_dispatch"]):
            raise AssertionError(f"sequence {name}: launches (K2, K1, K3) per view "
                                 f"{run['per_dispatch']}, expected {expected}")
        if run["launches"] != dict(zip(("K2", "K1", "K3"), (n * e for e in expected))):
            raise AssertionError(f"sequence {name} launched {run['launches']} in {n} views")
        if name == "skew":
            check_skew_results(run["results"], MAIN_CFG["t_e"], MAIN_CFG["t_a"], MAIN_CFG["size"])
        else:
            check_gaussian_results(run["results"])
        plain = [timed_pass(base["task"], base["model"], data, {"seed": MAIN_CFG["seed"],
                                                                  "task": extra})
                 for _ in range(SEQ_PASSES)]
        out[name] = {**run, **rate(run, run["pass_s"]),
                     "independent_views_per_s": rate(run, plain)["views_per_s"]}

    few = main_res["data"]
    sampler = SequenceSkewPSMSampler(
        get_or_fit_prior(few, None), get_or_fit_sequence_prior(few, None),
        image_extent=float(c["size"] - 1), device="cuda")
    view = next(iter(few.predict_views("test")))
    gen = view_generator(c["seed"], 0)
    with torch.inference_mode():
        img = torch.as_tensor(view["img"], device="cuda")[None]
        mu, cov, alpha = skew["task"].predict(skew["model"], img, generator=[gen])
        samples = sampler.sample_batch([gen], mu, cov, alpha=alpha, n=c["t_a"])
    out["rank_deficient"] = {"pairs": sum(1 for _ in few.predict_views("train")),
                             "non_finite": int((~torch.isfinite(samples)).sum().item()),
                             "coordinates": samples.numel()}
    return out


def sequence_coupling() -> dict:
    """Both sequence samplers on the card on a synthetic (ED, ES)
    population (150 ED contours at 256^2, each ES its ED shrunk by 0.8
    about its centroid; one prediction pair, T_e=10 x 25 pairs): the JAX
    package's coupling checks (tests/test_skew_sequence_samplers.py:261-281):
    each instant's mean within 8 px of its prediction, the mean ES area
    below the mean ED area."""
    import torch

    from contouring_uncertainty_torch.data.synthetic import lv_contour_points
    from contouring_uncertainty_torch.sampler import (
        SequencePSMSampler,
        SequenceSkewPSMSampler,
        fit_shape_prior,
    )

    c = MAIN_CFG
    rng = np.random.default_rng(1)
    ed = np.stack([lv_contour_points(rng, k=c["k"], size=c["size"]) for _ in range(150)])
    centre = ed.mean(axis=1, keepdims=True)
    es = centre + (ed - centre) * 0.8
    priors = (fit_shape_prior(np.concatenate([ed, es])),
              fit_shape_prior(np.concatenate([ed, es], axis=1)))
    mu = torch.as_tensor(np.stack([ed[7], es[7]]), dtype=torch.float32,
                         device="cuda")[:, None].repeat(1, c["t_e"], 1, 1)
    cov = torch.eye(2, device="cuda").expand(2, c["t_e"], c["k"], 2, 2) * 9.0
    samplers = {"gaussian": (SequencePSMSampler(*priors, device="cuda"), {}),
                "skew": (SequenceSkewPSMSampler(*priors, image_extent=float(c["size"] - 1),
                                                device="cuda"),
                         {"alpha": torch.full_like(mu, 2.0)})}

    def area(x):
        return 0.5 * (x[..., 0] * x[..., 1].roll(-1, -1)
                      - x[..., 0].roll(-1, -1) * x[..., 1]).sum(-1).abs()

    out = {}
    for name, (sampler, kw) in samplers.items():
        pop = sampler.sample_batch(torch.Generator().manual_seed(2), mu, cov, n=c["t_a"], **kw)
        pop = pop.reshape(2, -1, c["k"], 2)  # (instant, T_e * n, K, 2)
        drift = [float((pop[i].mean(0) - mu[i, 0]).norm(dim=-1).mean()) for i in range(2)]
        areas = [float(area(pop[i]).mean()) for i in range(2)]
        out[name] = {"pairs": pop.shape[1], "drift_px": drift, "area_px": areas}
        if not bool(torch.isfinite(pop).all()) or max(drift) >= 8.0 or areas[1] >= areas[0]:
            raise AssertionError(f"sequence {name} coupling: {out[name]}")
    return out


def soft_mask_check(main_res: dict) -> dict:
    """task.soft_mask over the test views: f32 sample masks in [0, 1]; the
    card's blur of one view's 500 sample masks within 1e-6 of the CPU's on
    the same masks; the flagship processors with no processor error."""
    import tempfile

    import torch

    from contouring_uncertainty_torch.ops.rasterize import rasterize_batch
    from contouring_uncertainty_torch.predict import gaussian_blur, run_predict
    from contouring_uncertainty_torch.results import run_processors

    c = MAIN_CFG
    cfg = {"seed": c["seed"], "task": {"soft_mask": True}}
    results = run_predict(main_res["task"], main_res["model"], main_res["data"], cfg,
                          split="test")
    for res in results:
        ps = res.pred_samples
        if ps.dtype != np.float32 or ps.min() < 0.0 or ps.max() > 1.0 or not 0.0 < ps.mean() < 1.0:
            raise AssertionError(f"soft sample masks: {ps.dtype} in [{ps.min()}, {ps.max()}]")
    samples = torch.as_tensor(results[0].contour_samples, device="cuda")
    masks = rasterize_batch(samples, c["size"], c["size"])
    blur_err = float((gaussian_blur(masks).cpu() - gaussian_blur(masks.cpu())).abs().max())
    with tempfile.TemporaryDirectory() as tmp:
        metrics = run_processors(results, Path(tmp),
                                 {"data": {"results_processors": PROCESSOR_NAMES}}, device="cuda")
    if blur_err > 1e-6 or "processor_errors" in metrics:
        raise AssertionError(f"soft masks: blur card vs CPU {blur_err:.2e}, processor errors "
                             f"{metrics.get('processor_errors')}")
    return {"views": len(results), "masks": masks[..., 0, 0].numel(),
            "blur_err": blur_err, "summary_keys": len(metrics)}


def view_batching(main_res: dict, skew: dict, profile_dir=None) -> dict:
    """predict_batch_views=BATCH_VIEWS against one view per dispatch, on the
    Gaussian and skew models of [5] and [10]: launches per dispatch, every
    view within BATCH_BUDGETS of its one-view result, then timed passes in
    turns (V=1, V=V, V=V, V=1 per round) and a profiled pass of each."""
    out = {}
    for name, base, extra, k3 in (("gaussian", main_res, {}, 1),
                                  ("skew", skew, {"skew_method": "esn", "grid_window": 64}, 3)):
        cfgs = {v: {"seed": MAIN_CFG["seed"], "predict_batch_views": v, "task": extra}
                for v in (1, BATCH_VIEWS)}
        runs = {v: serve(base["task"], base["model"], base["data"], cfg, 0,
                         profile_dir / f"batch_{name}_{v}" if profile_dir is not None else None)
                for v, cfg in cfgs.items()}
        n = runs[1]["views"]
        dispatches = -(-n // BATCH_VIEWS)
        per = runs[BATCH_VIEWS]["per_dispatch"]
        if len(per) != dispatches or any(d != (1, 0, k3) for d in per):
            raise AssertionError(f"batched {name}: launches (K2, K1, K3) per dispatch {per}")
        worst = {"mu": 0.0, "cov": 0.0, "pred_px": 0}
        for a, b in zip(runs[1]["results"], runs[BATCH_VIEWS]["results"]):
            worst = {"mu": max(worst["mu"], float(np.abs(a.mu - b.mu).max())),
                     "cov": max(worst["cov"], float(np.abs(a.cov - b.cov).max())),
                     "pred_px": max(worst["pred_px"], int((a.pred != b.pred).sum()))}
        if any(worst[key] > bar for key, bar in BATCH_BUDGETS.items()):
            raise AssertionError(f"batched {name}: a view differs from its one-view result by "
                                 f"{worst} (budgets {BATCH_BUDGETS})")
        passes = {1: [], BATCH_VIEWS: []}
        for _ in range(BATCH_ROUNDS):
            for v in (1, BATCH_VIEWS, BATCH_VIEWS, 1):
                passes[v].append(timed_pass(base["task"], base["model"], base["data"], cfgs[v]))
        out[name] = {"dispatches": dispatches, "per_dispatch": per, "worst": worst,
                     "runs": runs, **{v: rate(runs[v], passes[v]) for v in passes}}
    return out


def batched_kernel_checks(main_res: dict, batch: dict) -> dict:
    """K2 on one dispatch's head logits (BATCH_VIEWS views x T_e x N x K =
    1680 heatmaps of 256^2, bf16) against f64 at the bars of [3], and K3 on
    the dispatch's 2000 sampled contours against its plain version
    (bitwise, NaN positions matched), each timed beside its bound, K3 also
    beside torch.topk over its candidates."""
    import torch

    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel
    from contouring_uncertainty_torch.ops.spline import contour_spline
    from contouring_uncertainty_torch.tasks.dsnt_al import forward_views

    c = MAIN_CFG
    size = c["size"]
    views = list(main_res["data"].predict_views("test"))[:BATCH_VIEWS]
    imgs = torch.as_tensor(np.stack([v["img"] for v in views]), device="cuda")
    gens = [torch.Generator().manual_seed(i) for i in range(BATCH_VIEWS)]
    with torch.inference_mode():
        logits = forward_views(main_res["model"], imgs, c["t_e"], gens)["out"]
    rows = logits.reshape(-1, size * size)
    raw = dsnt_kernel.raw_moments_cuda(rows, size, size)
    ref = dsnt_kernel.raw_moments_plain(rows.double(), size, size)
    err = moment_errors(raw, ref, size, size)
    if not within_dsnt_bars(err):
        raise AssertionError(f"K2 at {tuple(rows.shape)} outside {DSNT_BARS}: {err}")
    k2_ms = cuda_ms(lambda: dsnt_kernel.raw_moments_cuda(rows, size, size))
    k2_plain = cuda_ms(lambda: dsnt_kernel.raw_moments_plain(rows, size, size), iters=5)
    r, hw = rows.shape
    k2_bound = {"bytes": (r * hw * rows.element_size() + r * 8 * 4) / HBM_BYTES_PER_S * 1e3,
                "operations": r * hw * 19 / F32_OPS_PER_S * 1e3}

    samples = torch.as_tensor(np.stack([res.contour_samples for res in
                                        batch["gaussian"]["runs"][BATCH_VIEWS]["results"][
                                            :BATCH_VIEWS]]), device="cuda")
    dense = contour_spline(samples.reshape(-1, c["k"], 2), n=1024).contiguous()
    check_selection(dense, size, size, f"one dispatch's sampled contours ({dense.shape[0]})")
    xs_k = select_kernel.min_k_crossings_kernel(dense, size)
    xs_p = select_kernel.min_k_crossings_plain(dense, size)
    k3_err = torch.where(xs_k == xs_p, 0.0, (xs_k - xs_p).abs()).nan_to_num(0.0).max().item()
    k3_ms = cuda_ms(lambda: select_kernel.min_k_crossings_kernel(dense, size))
    k3_plain = cuda_ms(lambda: select_kernel.min_k_crossings_plain(dense, size), iters=3)
    neg_cand = -select_kernel.crossing_candidates(dense, size)
    n_cross = int(torch.isfinite(neg_cand).sum().item())
    k3_lib = cuda_ms(lambda: torch.topk(neg_cand, 16, dim=-1), iters=3)
    del neg_cand
    m, e, _ = dense.shape
    k3_bound = {"bytes": (m * e * 2 * 4 + m * size * 16 * 4) / HBM_BYTES_PER_S * 1e3,
                "operations": (4 * m * e + 6 * n_cross) / F32_OPS_PER_S * 1e3}
    return {"k2": {"shape": [r, hw], "dtype": str(rows.dtype), "err": err,
                   "max_abs_err": (raw.double() - ref).abs().max().item(), "ms": k2_ms,
                   "plain_ms": k2_plain, "bound_ms": max(k2_bound.values()),
                   "bound_by": max(k2_bound, key=k2_bound.get)},
            "k3": {"shape": [m, e, size], "crossings": n_cross, "max_abs_err": k3_err,
                   "ms": k3_ms, "plain_ms": k3_plain, "library_ms": k3_lib,
                   "bound_ms": max(k3_bound.values()),
                   "bound_by": max(k3_bound, key=k3_bound.get)}}


# The segmentation baselines and the epistemic task ([12]), at the serving
# configuration of [5] (8-stage UNet, bf16 trunk, 256^2, N=2, the 6 test
# views of [5], seeded weights) with each task's config sizes; training at
# the width of [9] (f32, batch 32, AdamW, augmentation on).
SEG_CFG = {"mcdropout": dict(t_e=10, t_a=1, drop_block=True),
           "aleatoric": dict(t_e=1, t_a=25), "tta": dict(t_e=1, t_a=25),
           "ssn": dict(t_e=1, t_a=25, rank=10)}
SEG_PASSES = 3  # timed passes over the test views after the first
# The processor list of the JAX package's data=camus config.
SEG_PROCESSORS = ["instant_metrics", "calibration", "mutual_info", "clinical_metrics"]
SEG_CSVS = ["instant_metrics.csv", *(f"clinical/{t}_df.csv"
                                     for t in ("instant", "view", "patient", "volume"))]
# Card against CPU at 64^2, 4 stages, f32, the same draws: probabilities,
# and the `pred` pixels that may differ per view, each at a mean
# probability within `pred_p` of 0.5.
SEG_BARS = {"probs": 1e-4, "pred_px": 8, "pred_p": 1e-3, "epistemic_cov_rel": 1e-5}
SEG_TRAIN_PATIENTS = 14  # 8 training patients: 32 frames, one batch of 32
SEG_TRAIN_STEPS = 4  # timed steps after a warm-up step


def seg_task(name: str, data_params, dtype: str = "bfloat16", **small):
    """A baseline (or `epistemic`) with its config's sizes, the serving
    trunk dtype and, with `small`, the 64^2 model's kernels and strides."""
    from contouring_uncertainty_torch import tasks

    if name == "epistemic":
        return tasks.EpistemicUncertainty(
            data_params=data_params, t_e=MAIN_CFG["t_e"], t_a=MAIN_CFG["t_a"],
            model_kwargs=dict(drop_block=True, dtype=dtype, head_dtype=dtype, **small))
    cfg = dict(SEG_CFG[name])
    # The main head computes in f32 from the bf16 trunk's features, as the
    # JAX package's backbone builds it (it drops head_dtype).
    kwargs = dict(dtype=dtype, head_dtype="float32", drop_block=cfg.pop("drop_block", False),
                  **small)
    cls = {"mcdropout": tasks.McDropoutUncertainty, "aleatoric": tasks.AleatoricUncertainty,
           "tta": tasks.TTAUncertainty, "ssn": tasks.StochasticSegmentationNetwork}[name]
    return cls(data_params=data_params, model_kwargs=kwargs, **cfg)


def check_seg_results(results, t_e: int, t_a: int, size: int) -> None:
    """The JAX package's SegPredictor fields, shapes and dtypes; finite;
    binary sample populations are probabilities in [0, 1]."""
    for res in results:
        n = res.img.shape[0]
        want = {"pred": ((n, size, size), np.int32),
                "pred_samples": ((n, t_e, t_a, size, size), np.float32),
                "uncertainty_map": ((n, size, size), np.float32),
                "entropy_map": ((n, size, size), np.float32)}
        for key, (shape, dtype) in want.items():
            value = getattr(res, key)
            if value.shape != shape or value.dtype != dtype:
                raise AssertionError(f"{key}: {value.shape} {value.dtype}, expected {shape} "
                                     f"{np.dtype(dtype)}")
            if not np.isfinite(value).all():
                raise AssertionError(f"{key} has non-finite values")
        if res.mu is not None or res.contour_samples is not None:
            raise AssertionError("a segmentation result carries contour fields")
        if res.pred_samples.min() < 0 or res.pred_samples.max() > 1:
            raise AssertionError("binary sample probabilities outside [0, 1]")
        if set(res.instant_uncertainty) != {"entropy_mean"} or not np.isfinite(
                res.instant_uncertainty["entropy_mean"]).all():
            raise AssertionError(f"instant uncertainty {res.instant_uncertainty}")
        if (res.entropy_map[:, :10] != 0).any() or (res.entropy_map[:, -10:] != 0).any():
            raise AssertionError("the entropy map's 10-px border is not zero")


def morphology_reading(task, model, data) -> dict:
    """The post-processing of one view's untrained full-width sample masks
    (speckle, the loop's worst case): the fixed-point iteration counts, and
    the loop's host time (synchronised) and device time (CUDA events)."""
    import torch

    from contouring_uncertainty_torch.ops import morphology
    from contouring_uncertainty_torch.predict import view_generator

    view = next(iter(data.predict_views("test")))
    with torch.inference_mode():
        img = torch.as_tensor(view["img"], device="cuda")
        probs = task.predict_probs(model, img, view_generator(MAIN_CFG["seed"], 0))
        masks = torch.round(probs[..., 0, :, :])
        morphology.postprocess_batch(masks)  # warm-up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        morphology.postprocess_batch(masks)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    return {"masks": int(np.prod(masks.shape[:-2])), "host_ms": host_ms,
            "device_ms": start.elapsed_time(end), "iterations": dict(morphology.iterations),
            "foreground": float(masks.mean())}


def host_draw_ms(task, n: int, size: int) -> float:
    """Host time (synchronised, the median of 3) of the normals one view of
    an aleatoric or SSN task draws from its CPU generator and copies to the
    card, as the task draws them."""
    import torch

    from contouring_uncertainty_torch.predict import view_generator
    from contouring_uncertainty_torch.rng import draw_normal

    shapes = ([(1, task.t_a, n, task.n_channels, size, size)] if task.task_name == "aleatoric"
              else [(1, task.t_a, n, task.rank), (1, task.t_a, n, task.n_channels * size * size)])
    times = []
    for _ in range(3):
        gen = [view_generator(MAIN_CFG["seed"], 0)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for shape in shapes:
            draw_normal(gen, shape, device="cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[1]


def seg_processors(results) -> dict:
    """SEG_PROCESSORS on the card and on the CPU on the same views
    (`processors_card_vs_cpu`)."""
    return processors_card_vs_cpu(results, SEG_PROCESSORS, SEG_CSVS)


def seg_serving(main_res: dict, profile_dir=None) -> dict:
    """run_predict for each baseline and for epistemic at the serving width
    of [5] over its 6 test views: launches counted from 0 (K2 and K3: none
    for a baseline; one each per view for epistemic), outputs checked,
    views/s over SEG_PASSES passes, idle share and top device rows; the
    morphology reading and the processors, card against CPU, per baseline;
    epistemic's zero task covariances and its fused covariance against the
    f64 spread of the T_e means."""
    import torch

    from contouring_uncertainty_torch.predict import view_generator

    c = MAIN_CFG
    data = main_res["data"]
    cfg = {"seed": c["seed"]}
    out = {}
    for name in (*SEG_CFG, "epistemic"):
        t_start = time.perf_counter()
        task = seg_task(name, data.data_params)
        model = task.build_model(device="cuda", generator=torch.Generator().manual_seed(c["seed"]))
        run = serve(task, model, data, cfg, SEG_PASSES,
                    profile_dir / f"seg_{name}" if profile_dir is not None else None)
        n = run["views"]
        row = {**rate(run, run["pass_s"]), "views": n, "launches": run["launches"],
               "first_s": run["first_s"], "profile": run["profile"],
               "kernel_ms_per_view": run["kernel_ms_per_view"],
               "copy_ms_per_view": run["copy_ms_per_view"]}
        if name == "epistemic":
            if run["per_dispatch"] != [(1, 0, 1)] * n or run["launches"] != {
                    "K2": n, "K1": 0, "K3": n}:
                raise AssertionError(f"epistemic launches {run['launches']}, per view "
                                     f"{run['per_dispatch']}; expected K2 1 and K3 1 per view")
            check_gaussian_results(run["results"])
            worst = 0.0
            with torch.inference_mode():
                for vi, (view, res) in enumerate(zip(data.predict_views("test"),
                                                     run["results"])):
                    img = torch.as_tensor(view["img"], device="cuda")[None]
                    mu_te, cov_te = task.predict(model, img, [view_generator(c["seed"], vi)])
                    if cov_te.any():
                        raise AssertionError("the epistemic task's covariances are not 0")
                    mu_te = mu_te[0].double()
                    d = mu_te - mu_te.mean(dim=1, keepdim=True)
                    spread = (d[..., :, None] * d[..., None, :]).mean(dim=1).cpu().numpy()
                    worst = max(worst, float(np.abs(res.cov - spread).max()
                                             / np.abs(spread).max()))
            if worst > SEG_BARS["epistemic_cov_rel"]:
                raise AssertionError(f"epistemic fused covariance {worst:.2e} from the f64 "
                                     f"spread of the means")
            row["cov_rel_err"] = worst
        else:
            if run["launches"] != {"K2": 0, "K1": 0, "K3": 0}:
                raise AssertionError(f"{name} launched {run['launches']}: a baseline runs no "
                                     f"DSNT or crossing kernel")
            sizes = SEG_CFG[name]
            check_seg_results(run["results"], sizes["t_e"], sizes["t_a"], c["size"])
            row["morphology"] = morphology_reading(task, model, data)
            if name in ("aleatoric", "ssn"):
                row["draw_ms"] = host_draw_ms(task, 2, c["size"])
            t_proc = time.perf_counter()
            row["processors"] = seg_processors(run["results"])
            row["processors"]["seconds"] = time.perf_counter() - t_proc
        row["seconds"] = time.perf_counter() - t_start
        out[name] = row
        del model
        torch.cuda.empty_cache()
    return out


def seg_reference_check() -> dict:
    """Each baseline's SegPredictor on the card against the CPU at 64^2 (a
    4-stage f32 UNet, the same weights and CPU-generator draws, two views in
    one dispatch): probabilities within SEG_BARS["probs"], at most
    SEG_BARS["pred_px"] differing `pred` pixels per view, each at a mean
    probability within SEG_BARS["pred_p"] of 0.5; then postprocess_batch on
    the card bitwise equal to the CPU on the same rounded masks, with an
    equal-size-blobs tie."""
    import torch

    from contouring_uncertainty_torch.data.config import DataParams
    from contouring_uncertainty_torch.data.synthetic import make_arrays
    from contouring_uncertainty_torch.ops.morphology import postprocess_batch
    from contouring_uncertainty_torch.predict import SegPredictor, view_generator

    imgs = make_arrays(4, size=64, seed=1)[0].reshape(2, 2, 1, 64, 64)
    dp = DataParams(in_shape=(1, 64, 64), out_shape=(1, 64, 64))
    small = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3)
    out = {}
    for name in SEG_CFG:
        task = seg_task(name, dp, dtype="float32", **small)
        res = {}
        for device in ("cpu", "cuda"):
            model = task.build_model(device=device, generator=torch.Generator().manual_seed(3))
            gens = lambda: [view_generator(5, v) for v in range(2)]
            with torch.inference_mode():
                probs = task.predict_probs(model, torch.as_tensor(imgs, device=device), gens())
            pred = SegPredictor(task, model, device=device).batched(imgs, gens())
            res[device] = (probs.cpu(), {k: v.cpu() for k, v in pred.items()
                                         if isinstance(v, torch.Tensor)})
        (p_cpu, o_cpu), (p_gpu, o_gpu) = res["cpu"], res["cuda"]
        prob_err = float((p_gpu - p_cpu).abs().max())
        differ = o_gpu["pred"] != o_cpu["pred"]
        mean = o_cpu["pred_samples"].mean(dim=(2, 3))
        worst_p = float((mean[differ] - 0.5).abs().max()) if differ.any() else 0.0
        per_view = differ.flatten(1).sum(1).tolist()
        if (prob_err > SEG_BARS["probs"] or max(per_view) > SEG_BARS["pred_px"]
                or worst_p > SEG_BARS["pred_p"]):
            raise AssertionError(f"{name}: card vs CPU probabilities {prob_err:.2e}, pred pixels "
                                 f"{per_view} (mean p {worst_p:.2e} from 0.5)")
        masks = torch.round(p_cpu[..., 0, :, :])
        tie = torch.zeros(2, 64, 64)
        tie[:, 3:7, 3:7] = 1
        tie[:, 40:44, 20:24] = 1
        tie[1] = tie[1].flip(0)
        post_cpu = postprocess_batch(masks)
        post_gpu = postprocess_batch(masks.cuda()).cpu()
        ties = (postprocess_batch(tie), postprocess_batch(tie.cuda()).cpu())
        if not torch.equal(post_cpu, post_gpu) or not torch.equal(*ties):
            raise AssertionError(f"{name}: postprocess_batch on the card is not bitwise the CPU's")
        if ties[0][0].sum() != 16 or ties[0][0, 3:7, 3:7].sum() != 16:
            raise AssertionError("the tie did not keep the blob with the smallest label")
        out[name] = {"prob_err": prob_err, "pred_px": per_view}
    return out


def seg_training() -> dict:
    """Each baseline (and epistemic) at the training width of [9] (with its
    `drop_block`): one
    batch of 32 synthetic frames, a warm-up step, SEG_TRAIN_STEPS timed
    steps with augmentation (every loss finite; K2 and K3 launches per step
    counted), peak memory; then 10 steps on the batch without augmentation,
    in which the loss must fall."""
    import torch

    from contouring_uncertainty_torch.config import compose
    from contouring_uncertainty_torch.factory import build_task, build_trainer

    data = camus_data(SEG_TRAIN_PATIENTS, 256, TRAIN_CFG["seed"])
    batch = batch_of_32(data)
    out = {}
    for name in (*SEG_CFG, "epistemic"):
        cfg = compose(TRAIN_OVERRIDES + [f"task={name}"])  # drop_block on, as in [9]
        task = build_task(cfg, data.data_params)
        trainer = build_trainer(cfg, task)
        row = train_steps(name, trainer, batch, SEG_TRAIN_STEPS, fit_steps=10)
        want = SEG_TRAIN_STEPS if name == "epistemic" else 0
        if row["launches"] != {"K2": want, "K1": 0, "K3": 0}:
            raise AssertionError(f"{name}: launches over {SEG_TRAIN_STEPS} train steps "
                                 f"{row['launches']}")
        out[name] = row
        del trainer
        torch.cuda.empty_cache()
    return out


# The JSRT chest X-ray path ([13]): generated 256^2 films (60 train, 20 val,
# 20 test, `make_jsrt_arrays` fed through `JSRTContourData.from_arrays`),
# K = 120 landmarks in three structures (right lung 44, left lung 50,
# heart 26), one frame per view; serving at the widths of [5] (bf16 8-stage
# UNet and head, T_e=10 with drop_block, T_a=25), training at the width of
# [9] (f32, batch 32, AdamW, augmentation on).
JSRT_CFG = dict(n_items=100, size=256, seed=0)
JSRT_DIR = Path("outputs") / "chip_smoke_jsrt"  # git-ignored, removed at the end
JSRT_PASSES = 3  # timed passes over the test views after the first
JSRT_PROFILE_VIEWS = 2  # views of the profiled pass (the idle share's)
# The processor lists of the data configs lung-cont and lung.
JSRT_CONT_PROCESSORS = ["instant_metrics", "point_metrics", "calibration", "mutual_info",
                        "skewness", "lung_clinical"]
JSRT_SEG_PROCESSORS = ["instant_metrics", "calibration", "mutual_info", "lung_clinical"]
# (K2, K1, K3) per served view: DSNT-AL fills the samples' and mu's label
# maps (all three structures in one launch each); skew the samples', the
# three structures' level contours (one launch) and the mode's.
JSRT_PER_VIEW = {"dsnt-al": (1, 0, 2), "dsnt-skew5": (1, 0, 3), "mcdropout": (0, 0, 0)}
JSRT_SKEW_INDICES = (0, 5, 10, 15, 20)  # config/json/task/dsnt-skew5.json
# Card against CPU at 64^2 (4 stages, f32, the same weights and draws):
# `pred` (the label map of mu) pixels that may differ per frame; the share
# of the grouped umap's pixels beyond 1e-5, on the path and on the same
# (CPU) mu and cov. The lung_clinical CSV: the mask metrics equal, the
# contour areas and their spreads and errors within PROCESSOR_TOL's atol
# plus its rtol times the structure's reference area (f32 shoelace sums
# reduce in another order on the card).
JSRT_BARS = {"pred_px": 8, "umap_path": 2e-2, "umap_same": 1e-3}
JSRT_TRAIN_STEPS = 4  # timed steps after a warm-up step


def jsrt_data(n_items: int = JSRT_CFG["n_items"], size: int = JSRT_CFG["size"],
              seed: int = JSRT_CFG["seed"]):
    from contouring_uncertainty_torch.data.lung import JSRTContourData, make_jsrt_arrays

    return JSRTContourData.from_arrays(make_jsrt_arrays(n_items, size, seed))


def check_jsrt_results(results, t_e: int, t_a: int, size: int, skew: bool) -> int:
    """The JAX package's shapes for one frame of K = 120, label maps in
    {0, 1, 2} (sample maps uint8), the umap in [0, 1], everything finite
    but the skew samples, whose non-finite coordinates are returned."""
    k, bad = 120, 0
    shapes = {"mu": (1, k, 2), "cov": (1, k, 2, 2), "mode": (1, k, 2), "post_mu": (1, k, 2),
              "contour_samples": (1, t_e, t_a, k, 2), "pred_samples": (1, t_e, t_a, size, size),
              "pred": (1, size, size), "uncertainty_map": (1, size, size),
              "entropy_map": (1, size, size)}
    for res in results:
        for key, shape in shapes.items():
            value = getattr(res, key)
            if value.shape != shape:
                raise AssertionError(f"{key} shape {value.shape} != {shape}")
            finite = np.isfinite(value.astype(np.float64))
            if key == "contour_samples" and skew:
                bad += int((~finite).sum())
            elif not finite.all():
                raise AssertionError(f"{key} has non-finite values")
        if res.pred_samples.dtype != np.uint8 or res.pred.dtype != np.int32:
            raise AssertionError(f"label map dtypes {res.pred_samples.dtype} {res.pred.dtype}")
        for key in ("pred", "pred_samples"):
            if not set(np.unique(getattr(res, key)).tolist()) <= {0, 1, 2}:
                raise AssertionError(f"{key} holds {np.unique(getattr(res, key))}")
        if not (res.pred_samples == 2).any() or not (res.pred_samples == 1).any():
            raise AssertionError("no lung or heart painted in the sample label maps")
        if res.uncertainty_map.min() < 0 or res.uncertainty_map.max() > 1:
            raise AssertionError(f"umap outside [0, 1]: {res.uncertainty_map.min()} "
                                 f"{res.uncertainty_map.max()}")
        for group in (res.point_uncertainty, res.instant_uncertainty):
            for key, value in group.items():
                if not np.isfinite(value).all() and not skew:
                    raise AssertionError(f"{key} has non-finite values")
    return bad


def lung_csv_check(results, out_dir: Path) -> dict:
    """lung_clinical on the card and on the CPU on the same views: no
    processor error, view_df.csv with a row per view and a finite CTR_gt in
    (0, 1), the card's cells equal to the CPU's (JSRT_BARS' note)."""
    import torch

    from contouring_uncertainty_torch.results import run_processors

    cfg = {"data": {"results_processors": ["lung_clinical"]}}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = run_processors(results, out_dir / "gpu", cfg, device="cuda")
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / len(results)
    cpu = run_processors(results, out_dir / "cpu", cfg, device="cpu")
    for side, metrics in (("card", gpu), ("CPU", cpu)):
        if "processor_errors" in metrics:
            raise AssertionError(f"lung_clinical errors on the {side}: "
                                 f"{metrics['processor_errors']}")
    header, rows = read_csv_cells(out_dir / "gpu" / "lung_clinical" / "view_df.csv")
    ref_header, ref_rows = read_csv_cells(out_dir / "cpu" / "lung_clinical" / "view_df.csv")
    if header != ref_header or [r[0] for r in rows] != [r[0] for r in ref_rows]:
        raise AssertionError("lung_clinical: the card's columns or rows differ from the CPU's")
    if len(rows) != len(results):
        raise AssertionError(f"lung_clinical wrote {len(rows)} rows for {len(results)} views")
    ctr = [float(r[header.index("CTR_gt")]) for r in rows]
    if not all(0.0 < v < 1.0 for v in ctr):
        raise AssertionError(f"CTR_gt outside (0, 1): {ctr}")
    bad, cells = {}, 0
    for row, ref_row in zip(rows, ref_rows):
        for col, got, ref in zip(header[1:], row[1:], ref_row[1:]):
            cells += 1
            if col.startswith("Area_") and got not in ("True", "False", ""):
                area = float(ref_row[header.index("_".join(col.split("_")[:2]) + "_gt")])
                if abs(float(got) - float(ref)) > (PROCESSOR_TOL["atol"]
                                                   + PROCESSOR_TOL["rtol"] * area):
                    bad[f"{row[0]}:{col}"] = (got, ref)
            elif got != ref:
                bad[f"{row[0]}:{col}"] = (got, ref)
    if bad:
        raise AssertionError(f"lung_clinical on the card differs from the CPU: "
                             f"{dict(list(bad.items())[:10])}")
    return {"rows": len(rows), "cells": cells, "host_ms_per_view": host_ms,
            "ctr_gt": (min(ctr), max(ctr))}


def jsrt_serving(data, profile_dir=None) -> dict:
    """DSNT-AL, mcdropout and dsnt-skew5 on the JSRT test views at the
    serving widths of [5]: launches counted from 0 per view, outputs
    checked, views/s over JSRT_PASSES passes, idle share and top device
    rows; each data config's processor list on the card without error,
    and lung_clinical on the card equal to the CPU (DSNT-AL, mcdropout)."""
    import torch

    from contouring_uncertainty_torch.results import run_processors
    from contouring_uncertainty_torch.tasks import DSNTAleatoric, DSNTSkew

    c = MAIN_CFG
    dp = data.data_params
    bf16 = dict(drop_block=True, dtype="bfloat16", head_dtype="bfloat16")
    tasks = {
        "dsnt-al": (DSNTAleatoric(data_params=dp, t_e=c["t_e"], t_a=c["t_a"],
                                  model_kwargs=bf16), JSRT_CONT_PROCESSORS, {}),
        "mcdropout": (seg_task("mcdropout", dp), JSRT_SEG_PROCESSORS, {}),
        "dsnt-skew5": (DSNTSkew(data_params=dp, t_e=c["t_e"], t_a=c["t_a"], model_kwargs=bf16,
                                skew_indices=JSRT_SKEW_INDICES), [],
                       {"skew_method": "esn", "grid_window": 64}),
    }
    out = {}
    for name, (task, processors, extra) in tasks.items():
        t_start = time.perf_counter()
        model = task.build_model(device="cuda", generator=torch.Generator().manual_seed(c["seed"]))
        cfg = {"seed": c["seed"], "task": {"psm_path": str(JSRT_DIR / "psm.npz"), **extra}}
        run = serve(task, model, data, cfg, JSRT_PASSES,
                    profile_dir / f"jsrt_{name}" if profile_dir is not None else None,
                    profile_views=JSRT_PROFILE_VIEWS)
        row = {"serve_s": time.perf_counter() - t_start}
        n = run["views"]
        want = JSRT_PER_VIEW[name]
        # launch_ledger counts AleatoricPredictor's dispatches; a baseline's
        # SegPredictor has none, and launches none.
        per_view = run["per_dispatch"] if any(want) else [want] * n
        if (per_view != [want] * n
                or run["launches"] != dict(zip(("K2", "K1", "K3"), (n * w for w in want)))):
            raise AssertionError(f"jsrt {name}: launches {run['launches']}, per view "
                                 f"{run['per_dispatch']}; expected {want} (K2, K1, K3) per view")
        row.update({**rate(run, run["pass_s"]), "views": n, "launches": run["launches"],
                    "first_s": run["first_s"], "profile": run["profile"],
                    "profile_s": run["profile_s"],
                    "kernel_ms_per_view": run["kernel_ms_per_view"],
                    "copy_ms_per_view": run["copy_ms_per_view"]})
        if name == "mcdropout":
            for res in run["results"]:
                samples, pred = res.pred_samples, res.pred
                if (samples.shape != (1, SEG_CFG["mcdropout"]["t_e"], 1, c["size"], c["size"])
                        or samples.dtype != np.float32 or pred.dtype != np.int32
                        or not set(np.unique(samples).tolist()) <= {0.0, 1.0, 2.0}
                        or not set(np.unique(pred).tolist()) <= {0, 1, 2}
                        or not np.isfinite(res.entropy_map).all()):
                    raise AssertionError(f"mcdropout on JSRT: samples {samples.shape} "
                                         f"{samples.dtype} {np.unique(samples)}, pred "
                                         f"{pred.dtype} {np.unique(pred)}")
        else:
            row["non_finite_samples"] = check_jsrt_results(
                run["results"], c["t_e"], c["t_a"], c["size"], skew=name != "dsnt-al")
            row["sample_coordinates"] = int(sum(r.contour_samples.size for r in run["results"]))
        if processors:
            t_proc = time.perf_counter()
            metrics = run_processors(run["results"], JSRT_DIR / f"results_{name}",
                                     {"data": {"results_processors": processors}},
                                     device="cuda")
            if "processor_errors" in metrics:
                raise AssertionError(f"jsrt {name}: processor errors "
                                     f"{metrics['processor_errors']}")
            row["processors"] = {"keys": len(metrics),
                                 "host_ms_per_view": (time.perf_counter() - t_proc) * 1e3 / n}
            t_csv = time.perf_counter()
            row["processors"].update(lung_csv_check(run["results"], JSRT_DIR / f"lung_{name}"))
            row["processors"]["csv_check_s"] = time.perf_counter() - t_csv
        row["seconds"] = time.perf_counter() - t_start
        row["results"], row["model"], row["task"] = run["results"], model, task
        out[name] = row
        torch.cuda.empty_cache()
    return out


def jsrt_reference_check() -> dict:
    """DSNT-AL on JSRT on the card against the CPU at 64^2 (a 4-stage f32
    UNet, the same weights, prior and CPU-generator draws, 2 views in one
    dispatch): mu and cov within the bars of [7]; the label maps of the
    same (CPU) sample polygons bitwise; `pred` within JSRT_BARS["pred_px"]
    pixels per frame; the grouped umap within JSRT_BARS on the path and on
    the same (CPU) mu and cov."""
    import torch

    from contouring_uncertainty_torch.predict import (
        AleatoricPredictor,
        rasterize_labelmap,
        structure_umap_sum,
        view_generator,
    )
    from contouring_uncertainty_torch.sampler import PosteriorShapeModelSampler, fit_shape_prior
    from contouring_uncertainty_torch.tasks import DSNTAleatoric
    from contouring_uncertainty_torch.utils.umap import uncertainty_map

    data = jsrt_data(10, 64, 3)
    views = list(data.predict_views("test"))
    imgs = np.stack([v["img"] for v in views])
    groups = data.contour_groups
    task = DSNTAleatoric(data_params=data.data_params, t_e=2, t_a=8, model_kwargs=dict(
        kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3, drop_block=True))
    prior = fit_shape_prior(data.train_arrays("train")["contour"])
    outs = {}
    for device in ("cpu", "cuda"):
        model = task.build_model(device=device, generator=torch.Generator().manual_seed(3))
        predictor = AleatoricPredictor(task, model, PosteriorShapeModelSampler(prior, device=device),
                                       contour_groups=groups, device=device)
        gens = [view_generator(5, i) for i in range(len(views))]
        outs[device] = {k: v.cpu() for k, v in predictor.batched(imgs, gens).items()
                        if isinstance(v, torch.Tensor)}
    cpu, gpu = outs["cpu"], outs["cuda"]
    mu_err = (gpu["mu"] - cpu["mu"]).abs().max().item()
    cov_err = ((gpu["cov"] - cpu["cov"]).abs().max() / cpu["cov"].abs().max()).item()
    same_maps = rasterize_labelmap(cpu["contour_samples"].cuda(), groups, 64, 64).cpu()
    maps_equal = torch.equal(same_maps, rasterize_labelmap(cpu["contour_samples"], groups, 64, 64))
    pred_px = (gpu["pred"] != cpu["pred"]).flatten(-2).sum(-1).max().item()
    path_umap = ((gpu["uncertainty_map"] - cpu["uncertainty_map"]).abs() > 1e-5).float().mean()
    frames = lambda a: a.flatten(0, 1)

    def grouped_umap(mu, cov):
        return structure_umap_sum([uncertainty_map(frames(mu[..., a:b, :]),
                                                   frames(cov[..., a:b, :, :]), (64, 64))
                                   for a, b, _ in groups])

    same_umap = ((grouped_umap(cpu["mu"].cuda(), cpu["cov"].cuda()).cpu()
                  - grouped_umap(cpu["mu"], cpu["cov"])).abs() > 1e-5).float().mean()
    row = {"mu_px": mu_err, "cov_rel": cov_err, "label_maps_bitwise": maps_equal,
           "pred_px": pred_px, "umap_path": path_umap.item(), "umap_same": same_umap.item(),
           "labels": sorted(np.unique(cpu["pred_samples"].numpy()).tolist())}
    print(f"    JSRT GPU vs CPU (64^2, 4-stage f32, T_e=2, T_a=8, 2 views): mu {mu_err:.2e} px, "
          f"cov rel {cov_err:.2e}; label maps of the same samples bitwise: {maps_equal}; pred "
          f"pixels differing per frame at most {pred_px} (bar {JSRT_BARS['pred_px']}); grouped "
          f"umap pixels beyond 1e-5: path {row['umap_path']:.2e}, same mu and cov "
          f"{row['umap_same']:.2e}")
    if (mu_err > 1e-3 or cov_err > 1e-3 or not maps_equal or pred_px > JSRT_BARS["pred_px"]
            or row["umap_path"] > JSRT_BARS["umap_path"]
            or row["umap_same"] > JSRT_BARS["umap_same"] or row["labels"] != [0, 1, 2]):
        raise AssertionError(f"the JSRT GPU path disagrees with the CPU path: {row}")
    return row


def k2_reading(rows, size: int) -> dict:
    """K2 on (R, size^2) heatmap rows against f64 at the bars of [3], timed
    beside its plain version and its bound."""
    import torch

    from contouring_uncertainty_torch.ops import dsnt_kernel

    raw = dsnt_kernel.raw_moments_cuda(rows, size, size)
    ref = dsnt_kernel.raw_moments_plain(rows.double(), size, size)
    err = moment_errors(raw, ref, size, size)
    max_abs = (raw.double() - ref).abs().max().item()
    del ref
    if not within_dsnt_bars(err):
        raise AssertionError(f"K2 at {tuple(rows.shape)} outside {DSNT_BARS}: {err}")
    r, hw = rows.shape
    bound = {"bytes": (r * hw * rows.element_size() + r * 8 * 4) / HBM_BYTES_PER_S * 1e3,
             "operations": r * hw * 19 / F32_OPS_PER_S * 1e3}
    out = {"shape": [r, hw], "dtype": str(rows.dtype), "err": err, "max_abs_err": max_abs,
           "ms": cuda_ms(lambda: dsnt_kernel.raw_moments_cuda(rows, size, size)),
           "plain_ms": cuda_ms(lambda: dsnt_kernel.raw_moments_plain(rows, size, size), iters=3),
           "bound_ms": max(bound.values()), "bound_by": max(bound, key=bound.get)}
    torch.cuda.empty_cache()
    return out


def k3_reading(dense, size: int, label: str) -> dict:
    """K3 on (M, E, 2) polygons against its plain version (bitwise, NaN
    positions matched), timed beside its plain version, its bound and
    torch.topk over its candidates."""
    import torch

    from contouring_uncertainty_torch.ops import select_kernel

    check_selection(dense, size, size, label)
    xs_k = select_kernel.min_k_crossings_kernel(dense, size)
    xs_p = select_kernel.min_k_crossings_plain(dense, size)
    err = torch.where(xs_k == xs_p, 0.0, (xs_k - xs_p).abs()).nan_to_num(0.0).max().item()
    neg_cand = -select_kernel.crossing_candidates(dense, size)
    n_cross = int(torch.isfinite(neg_cand).sum().item())
    lib = cuda_ms(lambda: torch.topk(neg_cand, 16, dim=-1), iters=3)
    del neg_cand
    m, e, _ = dense.shape
    bound = {"bytes": (m * e * 2 * 4 + m * size * 16 * 4) / HBM_BYTES_PER_S * 1e3,
             "operations": (4 * m * e + 6 * n_cross) / F32_OPS_PER_S * 1e3}
    return {"shape": [m, e, size], "crossings": n_cross, "max_abs_err": err,
            "ms": cuda_ms(lambda: select_kernel.min_k_crossings_kernel(dense, size)),
            "plain_ms": cuda_ms(lambda: select_kernel.min_k_crossings_plain(dense, size),
                                iters=3),
            "library_ms": lib, "bound_ms": max(bound.values()),
            "bound_by": max(bound, key=bound.get)}


def served_logits(row: dict, t_e: int):
    """The head logits of one served view (its first frames' T_e MC
    forwards), as the predictor computes them."""
    import torch

    from contouring_uncertainty_torch.tasks.dsnt_al import forward_views

    view = row["results"][0]
    with torch.inference_mode():
        return forward_views(row["model"], torch.as_tensor(view.img, device="cuda")[None],
                             t_e, [torch.Generator().manual_seed(1)])["out"]


def structure_polygons(view, groups):
    """A served view's sampled contours of each structure, splined to
    closed polygons of 1024 vertices: (G * samples, 1024, 2)."""
    import torch

    from contouring_uncertainty_torch.ops.spline import contour_spline

    samples = torch.as_tensor(view.contour_samples, device="cuda")
    return torch.stack([contour_spline(samples[..., a:b, :], n=1024, close=False)
                        for a, b, _ in groups]).reshape(-1, 1024, 2).contiguous()


def jsrt_kernel_checks(serving: dict, train_logits, groups) -> dict:
    """K2 on one served view's head logits (T_e x 1 frame x 120 = 1200
    heatmaps of 256^2, bf16) and on one training batch's (32 x 120 = 3840,
    f32) against f64 at the bars of [3]; K3 on one view's structure
    polygons (3 x 250 samples, 1024 vertices) against its plain version
    (bitwise, NaN positions matched); each timed beside its bound, K3 also
    beside torch.topk over its candidates."""
    c = MAIN_CFG
    size = c["size"]
    al = serving["dsnt-al"]
    out = {f"k2_{label}": k2_reading(logits.reshape(-1, size * size), size)
           for label, logits in (("serving", served_logits(al, c["t_e"])),
                                 ("training", train_logits))}
    dense = structure_polygons(al["results"][0], groups)
    out["k3"] = k3_reading(dense, size, f"one JSRT view's structure polygons ({dense.shape[0]})")
    return out


def jsrt_training(data) -> dict:
    """DSNT-AL on the JSRT training films at the width of [9] (f32, batch
    32, AdamW, augmentation on): `train_steps` (JSRT_TRAIN_STEPS timed, K2
    1 per step, then 10 in which the loss must fall), then one validation
    batch (launches counted, finite loss and Dice). Returns the trained
    head's f32 logits of the batch for K2's check."""
    import torch

    from contouring_uncertainty_torch.config import compose
    from contouring_uncertainty_torch.factory import build_task, build_trainer
    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel
    from contouring_uncertainty_torch.train.trainer import _iterate, _to_device

    cfg = compose(["data=lung-cont", "task=dsnt-al", "task/model=unet2",
                   "task.model.drop_block=true", "task.optim.name=adamw", "task.optim.lr=1e-3",
                   "task.optim.weight_decay=1e-3", f"trainer.batch_size={TRAIN_CFG['batch']}",
                   "trainer.augment=true", f"seed={TRAIN_CFG['seed']}",
                   f"save_path={JSRT_DIR}"])
    task = build_task(cfg, data.data_params)
    trainer = build_trainer(cfg, task)
    batch = batch_of_32(data)
    row = train_steps("JSRT training", trainer, batch, JSRT_TRAIN_STEPS, fit_steps=10)
    if row["per_step"] != {"K2": 1, "K1": 0, "K3": 0}:
        raise AssertionError(f"JSRT training: launches per step {row['per_step']}")
    val = _to_device(next(_iterate(data.train_arrays("val"), TRAIN_CFG["batch"],
                                   np.random.default_rng(0), shuffle=False, drop_last=False)),
                     trainer.device)
    dsnt_kernel.row_launches = dsnt_kernel.col_launches = select_kernel.launches = 0
    with torch.no_grad():
        logs = {k: float(v) for k, v in task.val_metrics(trainer.model, val).items()}
    per_val = {"K2": dsnt_kernel.row_launches, "K1": dsnt_kernel.col_launches,
               "K3": select_kernel.launches}
    if per_val != {"K2": 1, "K1": 0, "K3": 1} or not all(np.isfinite(list(logs.values()))):
        raise AssertionError(f"JSRT validation batch: launches {per_val}, logs {logs}")
    with torch.no_grad():
        logits = trainer.model(batch["img"], deterministic=True)["out"].float()
    del trainer
    torch.cuda.empty_cache()
    return {**row, "per_val_batch": per_val, "val": logs, "val_rows": int(val["img"].shape[0]),
            "logits": logits}


# The CAMUS source ([14]): CamusContourData.from_arrays over the films of
# [5]'s draws (8 patients, 6 test views, 256^2), the landmarks extracted
# from the label masks; served as `data=camus-cont task=dsnt-al` at the
# width of [5] with the LV alone (K=21) and with [BG, LV, MYO] (K=42 in two
# contour groups, MYO painted first and the LV last); LV+MYO trained at the
# width of [9] on one batch of 32.
CAMUS_LABELS = {"LV": ("BG", "LV"), "LV+MYO": ("BG", "LV", "MYO")}
CAMUS_PER_VIEW = {"LV": (1, 0, 1), "LV+MYO": (1, 0, 2)}  # (K2, K1, K3) per view
CAMUS_PASSES = 2  # timed passes over the test views after the first
CAMUS_DIR = Path("outputs") / "chip_smoke_camus"  # git-ignored, removed at the end
CAMUS_TRAIN_STEPS = 3  # timed steps after a warm-up step
# The other backbones ([15]), each at its JSON config's full width (f32),
# DSNT-AL trained on one batch of 32 at 256^2 (K=21) and served over the 6
# test views at T_e=10 (dropout 0.1 where the config has none) and T_a=25;
# then mcdropout served on ENet.
BACKBONES = {"enet": ["task/model=enet"], "deeplabv3": ["task/model=deeplabv3"],
             "resnet": ["task/model=resnet"],
             "unet2 residual attention": ["task/model=unet2", "task.model.drop_block=true",
                                          "task.model.residual=true",
                                          "task.model.attention=true"]}
BACKBONE_PASSES = 2  # timed passes over the test views after the first
BACKBONE_TRAIN_STEPS = 3
# Each backbone's GPU forward against the CPU at 64^2 at a small depth,
# relative to the output's largest magnitude (f32, TF32 off).
BACKBONE_SMALL = {"enet": dict(init_channels=8), "deeplabv3": dict(base=8, layers=(1, 1, 1, 1)),
                  "resnet": dict(layers=(1, 1, 1, 1), sigma_out=3),
                  "unet2 residual attention": dict(
                      kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3,
                      residual=True, attention=True, drop_block=True)}
BACKBONE_BAR = 3e-4


def check_camus_results(results, k: int, labels) -> None:
    """Shapes of K landmarks, finite values, uint8 sample label maps in
    {0} + labels with every label painted, an int32 `pred`, the umap in
    [0, 1]."""
    c = MAIN_CFG
    n, s = 2, c["size"]
    shapes = {"mu": (n, k, 2), "cov": (n, k, 2, 2),
              "contour_samples": (n, c["t_e"], c["t_a"], k, 2),
              "pred_samples": (n, c["t_e"], c["t_a"], s, s), "pred": (n, s, s),
              "uncertainty_map": (n, s, s), "entropy_map": (n, s, s)}
    for res in results:
        for key, shape in shapes.items():
            value = getattr(res, key)
            if value.shape != shape or not np.isfinite(value.astype(np.float64)).all():
                raise AssertionError(f"{key}: shape {value.shape} (want {shape}) or not finite")
        if res.pred_samples.dtype != np.uint8 or res.pred.dtype != np.int32:
            raise AssertionError(f"label map dtypes {res.pred_samples.dtype} {res.pred.dtype}")
        painted = set(np.unique(res.pred_samples).tolist())
        if painted != {0, *labels}:
            raise AssertionError(f"sample label maps hold {painted}, want {{0, *{labels}}}")
        if not set(np.unique(res.pred).tolist()) <= {0, *labels}:
            raise AssertionError(f"pred holds {np.unique(res.pred)}")
        if res.uncertainty_map.min() < 0 or res.uncertainty_map.max() > 1:
            raise AssertionError("umap outside [0, 1]")


def processors_card_vs_cpu(results, names, csvs) -> dict:
    """The results processors `names` on the card and on the CPU on the same
    views: no processor error, the same summary keys and CSV rows and
    columns, the card's values equal to the CPU's within PROCESSOR_TOL
    (`differing`)."""
    import tempfile

    import torch

    from contouring_uncertainty_torch.results import run_processors

    cfg = {"data": {"results_processors": list(names)}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu = run_processors(results, tmp / "gpu", cfg, device="cuda")
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / len(results)
        t0 = time.perf_counter()
        cpu = run_processors(results, tmp / "cpu", cfg, device="cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3 / len(results)
        for side, metrics in (("card", gpu), ("CPU", cpu)):
            if "processor_errors" in metrics:
                raise AssertionError(f"processor errors on the {side}: "
                                     f"{metrics['processor_errors']}")
        if set(gpu) != set(cpu):
            raise AssertionError(f"summary keys differ: {sorted(set(gpu) ^ set(cpu))}")
        bad = {k: (gpu[k], cpu[k]) for k in cpu if differing(k, gpu[k], cpu[k])}
        cells = 0
        for name in csvs:
            header, rows = read_csv_cells(tmp / "gpu" / name)
            ref_header, ref_rows = read_csv_cells(tmp / "cpu" / name)
            if header != ref_header or [r[0] for r in rows] != [r[0] for r in ref_rows]:
                raise AssertionError(f"{name}: the card's columns or rows differ from the CPU's")
            for row, ref_row in zip(rows, ref_rows):
                for col, got, ref in zip(header[1:], row[1:], ref_row[1:]):
                    cells += 1
                    if differing(col, got, ref):
                        bad[f"{name}:{row[0]}:{col}"] = (got, ref)
        if bad:
            raise AssertionError(f"the card's processor outputs differ from the CPU's "
                                 f"(tolerance {PROCESSOR_TOL}): {dict(list(bad.items())[:10])}")
    return {"keys": len(gpu), "cells": cells, "host_ms_per_view": host_ms,
            "cpu_ms_per_view": cpu_ms}


def camus_serving(profile_dir=None) -> dict:
    """`data=camus-cont task=dsnt-al` at the serving width of [5] on the
    CAMUS source, LV alone and LV+MYO: launches per view counted from 0,
    outputs checked, views/s over CAMUS_PASSES passes and the idle share
    of a profiled pass over 2 views; the `camus-cont` processor list on
    LV+MYO and the `camus` list on the LV, card against CPU."""
    import torch

    from contouring_uncertainty_torch.tasks import DSNTAleatoric

    c = MAIN_CFG
    out = {}
    for name, labels in CAMUS_LABELS.items():
        t_start = time.perf_counter()
        data = camus_data(c["n_patients"], c["size"], c["seed"], labels)
        data_s = time.perf_counter() - t_start
        task = DSNTAleatoric(data_params=data.data_params, t_e=c["t_e"], t_a=c["t_a"],
                             model_kwargs=dict(drop_block=True, dtype="bfloat16",
                                               head_dtype="bfloat16"))
        model = task.build_model(device="cuda", generator=torch.Generator().manual_seed(c["seed"]))
        cfg = {"seed": c["seed"], "task": {"psm_path": str(CAMUS_DIR / f"psm_{name}.npz")}}
        run = serve(task, model, data, cfg, CAMUS_PASSES,
                    profile_dir / f"camus_{name}" if profile_dir is not None else None,
                    profile_views=2)
        n, want = run["views"], CAMUS_PER_VIEW[name]
        if (run["per_dispatch"] != [want] * n
                or run["launches"] != dict(zip(("K2", "K1", "K3"), (n * w for w in want)))):
            raise AssertionError(f"camus {name}: launches {run['launches']}, per view "
                                 f"{run['per_dispatch']}; expected {want} (K2, K1, K3) per view")
        k = 21 * (len(labels) - 1)
        check_camus_results(run["results"], k, list(range(1, len(labels))))
        names, csvs = ((PROCESSOR_NAMES, CSV_FILES) if name == "LV+MYO"
                       else (SEG_PROCESSORS, SEG_CSVS))
        t_proc = time.perf_counter()
        proc = processors_card_vs_cpu(run["results"], names, csvs)
        proc.update(names=names, seconds=time.perf_counter() - t_proc)
        out[name] = {**rate(run, run["pass_s"]), "views": n, "k": k, "launches": run["launches"],
                     "first_s": run["first_s"], "profile": run["profile"], "data_s": data_s,
                     "kernel_ms_per_view": run["kernel_ms_per_view"],
                     "copy_ms_per_view": run["copy_ms_per_view"], "processors": proc,
                     "results": run["results"], "model": model, "task": task, "data": data,
                     "seconds": time.perf_counter() - t_start}
        torch.cuda.empty_cache()
    return out


def camus_reference_check() -> dict:
    """DSNT-AL on LV+MYO on the card against the CPU at 64^2 (a 4-stage f32
    UNet, the same weights, prior and draws, 2 views in one dispatch): mu
    and cov within the bars of [7]; the label maps of the same (CPU)
    samples bitwise on both; and in them the LV (1) painted over the MYO
    (2): label 1 wherever the LV polygon is filled, 2 where only the
    epicardium's is."""
    import torch

    from contouring_uncertainty_torch.ops.rasterize import rasterize_batch
    from contouring_uncertainty_torch.predict import (
        AleatoricPredictor,
        rasterize_labelmap,
        view_generator,
    )
    from contouring_uncertainty_torch.sampler import PosteriorShapeModelSampler, fit_shape_prior
    from contouring_uncertainty_torch.tasks import DSNTAleatoric

    data = camus_data(5, 64, 2, CAMUS_LABELS["LV+MYO"])
    views = list(data.predict_views("test"))
    imgs = np.stack([v["img"] for v in views])
    groups = data.contour_groups
    task = DSNTAleatoric(data_params=data.data_params, t_e=2, t_a=8, model_kwargs=dict(
        kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3, drop_block=True))
    prior = fit_shape_prior(data.train_arrays("train")["contour"])
    outs = {}
    for device in ("cpu", "cuda"):
        model = task.build_model(device=device, generator=torch.Generator().manual_seed(3))
        sampler = PosteriorShapeModelSampler(prior, device=device)
        predictor = AleatoricPredictor(task, model, sampler, contour_groups=groups,
                                       device=device)
        gens = [view_generator(5, i) for i in range(len(views))]
        outs[device] = {k: v.cpu() for k, v in predictor.batched(imgs, gens).items()
                        if isinstance(v, torch.Tensor)}
    cpu, gpu = outs["cpu"], outs["cuda"]
    mu_err = (gpu["mu"] - cpu["mu"]).abs().max().item()
    cov_err = ((gpu["cov"] - cpu["cov"]).abs().max() / cpu["cov"].abs().max()).item()
    samples = cpu["contour_samples"]
    maps = rasterize_labelmap(samples.cuda(), groups, 64, 64).cpu()
    lv = rasterize_batch(samples[..., :21, :], 64, 64) > 0
    myo = rasterize_batch(samples[..., 21:, :], 64, 64) > 0
    want = torch.where(lv, 1.0, torch.where(myo, 2.0, 0.0))
    if not (torch.equal(maps, rasterize_labelmap(samples, groups, 64, 64))
            and torch.equal(maps, want)):
        raise AssertionError("LV+MYO label maps: card and CPU differ, or the LV is not painted "
                             "over the MYO")
    overlap = int((lv & myo).sum().item())
    if overlap == 0 or mu_err > 1e-3 or cov_err > 1e-3:
        raise AssertionError(f"LV+MYO card vs CPU: mu {mu_err:.2e} px, cov {cov_err:.2e}, "
                             f"LV/MYO overlap {overlap} px")
    return {"mu_px": mu_err, "cov_rel": cov_err, "overlap_px": overlap,
            "maps": int(maps[..., 0, 0].numel())}


def batch_of_32(data):
    """One batch of 32 training frames of `data` (its training split
    repeated as needed), on the card."""
    from contouring_uncertainty_torch.train.trainer import _iterate, _to_device

    arrays = data.train_arrays("train")
    reps = -(-TRAIN_CFG["batch"] // len(arrays["img"]))
    arrays = {k: np.concatenate([v] * reps) for k, v in arrays.items()}
    return _to_device(next(_iterate(arrays, TRAIN_CFG["batch"], np.random.default_rng(1))),
                      "cuda")


def train_steps(label: str, trainer, batch, steps: int, fit_steps: int = 0,
                wgrad=None) -> dict:
    """A warm-up step, then `steps` timed steps (every loss finite, launches
    counted from 0: their totals and per step; the conv epilogue's and the
    1x1 weight gradient's in every step, `epilogue_per_step`, `wgrad`
    kernel launches a step where given), peak memory; with
    `fit_steps`, that many more steps without augmentation, in which the
    loss must fall."""
    import torch

    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel

    trainer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with epilogue_ledger() as epi:
        losses = [float(trainer.train_step(batch, 0)["loss"])]
        dsnt_kernel.row_launches = dsnt_kernel.col_launches = select_kernel.launches = 0
        zero_wgrad_launches()
        steps_ms = []
        for step in range(1, 1 + steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(batch, step)["loss"]))
            steps_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"K2": dsnt_kernel.row_launches, "K1": dsnt_kernel.col_launches,
                "K3": select_kernel.launches}
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: non-finite training loss {losses}")
    if wgrad_launches()[0] != sum(step[3] for step in epi[1:]):
        raise AssertionError(f"{label}: {wgrad_launches()[0]} 1x1 weight gradient launches in "
                             f"the {steps} timed steps, counted {[s[3] for s in epi[1:]]}")
    out = {"losses": losses, "launches": launches,
           "per_step": {k: v / steps for k, v in launches.items()},
           "epilogue_per_step": epilogue_per_step(label, epi, wgrad=wgrad),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if fit_steps:
        trainer.config.augment = False
        fit = [float(trainer.train_step(batch, s)["loss"])
               for s in range(steps + 1, steps + 1 + fit_steps)]
        if not (np.isfinite(fit).all() and fit[-1] < fit[0]):
            raise AssertionError(f"{label}: the loss on one fixed batch did not fall: {fit}")
        out["fit"] = (fit[0], fit[-1])
    steps_ms.sort()
    out.update(step_ms=steps_ms[len(steps_ms) // 2], step_ms_range=(steps_ms[0], steps_ms[-1]))
    return out


def camus_training(data) -> dict:
    """`data=camus-cont` with [BG, LV, MYO] (K=42) at the training width of
    [9] on one batch of 32: CAMUS_TRAIN_STEPS timed steps (K2 1 per step,
    on (1344, 65536) f32), peak memory, then 8 steps in which the loss must
    fall, and one batch of the val split (K2 1, K3 1)."""
    import torch

    from contouring_uncertainty_torch.config import compose
    from contouring_uncertainty_torch.factory import build_task, build_trainer
    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel
    from contouring_uncertainty_torch.train.trainer import _iterate, _to_device

    cfg = compose(["data=camus-cont", "data.labels=[BG, LV, MYO]", "task=dsnt-al",
                   "task.model.drop_block=true", "task.optim.name=adamw", "task.optim.lr=1e-3",
                   "task.optim.weight_decay=1e-3", f"trainer.batch_size={TRAIN_CFG['batch']}",
                   "trainer.augment=true", f"seed={TRAIN_CFG['seed']}",
                   f"save_path={CAMUS_DIR}"])
    task = build_task(cfg, data.data_params)
    trainer = build_trainer(cfg, task)
    batch = batch_of_32(data)
    out = train_steps("LV+MYO training", trainer, batch, CAMUS_TRAIN_STEPS, fit_steps=8)
    if out["per_step"] != {"K2": 1, "K1": 0, "K3": 0}:
        raise AssertionError(f"LV+MYO training: launches per step {out['per_step']}")
    val = _to_device(next(_iterate(data.train_arrays("val"), TRAIN_CFG["batch"],
                                   np.random.default_rng(0), shuffle=False, drop_last=False)),
                     trainer.device)
    dsnt_kernel.row_launches = dsnt_kernel.col_launches = select_kernel.launches = 0
    with torch.no_grad():
        logs = {k: float(v) for k, v in task.val_metrics(trainer.model, val).items()}
    per_val = {"K2": dsnt_kernel.row_launches, "K1": dsnt_kernel.col_launches,
               "K3": select_kernel.launches}
    if per_val != {"K2": 1, "K1": 0, "K3": 1} or not all(np.isfinite(list(logs.values()))):
        raise AssertionError(f"LV+MYO validation batch: launches {per_val}, logs {logs}")
    del trainer
    torch.cuda.empty_cache()
    return {**out, "per_val_batch": per_val, "val": logs, "val_rows": int(val["img"].shape[0])}


def backbone_reference_check(name: str) -> float:
    """The backbone at a small depth at 64^2, the same weights on the card
    and on the CPU, deterministic: the largest difference of any output
    relative to that output's largest magnitude (bar BACKBONE_BAR)."""
    import torch

    from contouring_uncertainty_torch.models import build_backbone

    model_name = name.split()[0]
    out_shape = (21, 2) if model_name == "resnet" else (21, 64, 64)
    img = torch.as_tensor(np.random.default_rng(4).normal(size=(2, 1, 64, 64)), dtype=torch.float32)
    model = build_backbone(model_name, (1, 64, 64), out_shape, **BACKBONE_SMALL[name])
    model.reset_parameters(torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = model.eval()(img)
        got = model.cuda()(img.cuda())
    worst = 0.0
    for key, value in ref.items():
        for r, g in zip(value if isinstance(value, list) else [value],
                        got[key] if isinstance(value, list) else [got[key]]):
            worst = max(worst, ((g.cpu() - r).abs().max() / r.abs().max()).item())
    if worst > BACKBONE_BAR:
        raise AssertionError(f"{name} on the card vs the CPU at 64^2: {worst:.2e} of the output "
                             f"(bar {BACKBONE_BAR})")
    return worst


def backbones(camus: dict, profile_dir=None) -> dict:
    """Each of BACKBONES at its config's full width: DSNT-AL trained on one
    batch of 32 (launches per step: K2 1, Resnet 0), served over the LV
    test views of [14] at T_e=10, T_a=25 (K2 1 per view, Resnet 0; K3 1),
    its small forward on the card against the CPU; then mcdropout served on
    ENet (no K2 or K3)."""
    import torch

    from contouring_uncertainty_torch.config import compose
    from contouring_uncertainty_torch.factory import build_task, build_trainer

    c = MAIN_CFG
    data = camus["LV"]["data"]
    train_data = camus_data(SEG_TRAIN_PATIENTS, 256, TRAIN_CFG["seed"])
    batch = batch_of_32(train_data)
    out = {}
    for name, overrides in BACKBONES.items():
        t_start = time.perf_counter()
        cfg = compose(["data=camus-cont", "task=dsnt-al", *overrides, "task.optim.name=adamw",
                       f"trainer.batch_size={TRAIN_CFG['batch']}", "trainer.augment=true",
                       f"seed={TRAIN_CFG['seed']}", f"save_path={CAMUS_DIR}"])
        task = build_task(cfg, train_data.data_params)
        trainer = build_trainer(cfg, task)
        train = train_steps(f"{name} training", trainer, batch, BACKBONE_TRAIN_STEPS,
                            wgrad=DEEPLAB_1X1 if name == "deeplabv3" else None)
        k2 = 0 if name == "resnet" else 1
        if train["per_step"] != {"K2": k2, "K1": 0, "K3": 0}:
            raise AssertionError(f"{name} training: launches per step {train['per_step']}")
        del trainer
        serve_cfg = compose(["data=camus-cont", "task=dsnt-al", *overrides,
                             f"task.t_e={c['t_e']}", f"task.t_a={c['t_a']}"])
        if serve_cfg["task"]["model"].get("dropout") == 0.0:  # DeepLabV3, Resnet
            serve_cfg["task"]["model"]["dropout"] = 0.1
        task = build_task(serve_cfg, data.data_params)
        model = task.build_model(device="cuda", generator=torch.Generator().manual_seed(c["seed"]))
        run = serve(task, model, data, {"seed": c["seed"], "task": {
            "psm_path": str(CAMUS_DIR / "psm_LV.npz")}}, BACKBONE_PASSES,
            profile_dir / f"backbone_{name.split()[0]}" if profile_dir is not None else None,
            profile_views=2)
        n, want = run["views"], (k2, 0, 1)
        if run["per_dispatch"] != [want] * n:
            raise AssertionError(f"{name} serving: launches per view {run['per_dispatch']}, "
                                 f"expected {want}")
        check_camus_results(run["results"], 21, [1])
        out[name] = {**rate(run, run["pass_s"]), "views": n, "launches": run["launches"],
                     "first_s": run["first_s"], "train": train,
                     "kernel_ms_per_view": run["kernel_ms_per_view"],
                     "copy_ms_per_view": run["copy_ms_per_view"],
                     "reference_err": backbone_reference_check(name),
                     "params": sum(p.numel() for p in model.parameters()),
                     "results": run["results"], "model": model,
                     "seconds": time.perf_counter() - t_start}
        torch.cuda.empty_cache()
    t_start = time.perf_counter()
    seg_cfg = compose(["data=camus", "task=mcdropout", "task/model=enet", f"task.t_e={c['t_e']}"])
    task = build_task(seg_cfg, data.data_params)
    model = task.build_model(device="cuda", generator=torch.Generator().manual_seed(c["seed"]))
    run = serve(task, model, data, {"seed": c["seed"]}, BACKBONE_PASSES, profile_views=2)
    if run["launches"] != {"K2": 0, "K1": 0, "K3": 0}:
        raise AssertionError(f"mcdropout on ENet launched {run['launches']}")
    check_seg_results(run["results"], c["t_e"], 1, c["size"])
    out["mcdropout enet"] = {**rate(run, run["pass_s"]), "views": run["views"],
                             "launches": run["launches"], "first_s": run["first_s"],
                             "kernel_ms_per_view": run["kernel_ms_per_view"],
                             "copy_ms_per_view": run["copy_ms_per_view"],
                             "seconds": time.perf_counter() - t_start}
    return out


def camus_kernel_checks(camus: dict, bb: dict) -> dict:
    """K2 on one LV+MYO served view's bf16 logits (T_e x 2 frames x 42 = 840
    heatmaps of 256^2) and on one DeepLabV3 served view's f32 logits (420),
    against f64 at the bars of [3]; K3 on one LV+MYO view's 1,000 structure
    polygons (2 x 500 samples) against its plain version; each timed beside
    its bound and its plain version."""
    size, t_e = MAIN_CFG["size"], MAIN_CFG["t_e"]
    myo = camus["LV+MYO"]
    out = {"k2_lv_myo": k2_reading(served_logits(myo, t_e).reshape(-1, size * size), size),
           "k2_deeplabv3": k2_reading(served_logits(bb["deeplabv3"], t_e)
                                      .reshape(-1, size * size), size)}
    dense = structure_polygons(myo["results"][0], myo["data"].contour_groups)
    out["k3_lv_myo"] = k3_reading(dense, size, f"one LV+MYO view's polygons ({dense.shape[0]})")
    return out


# Deep ensembles, bf16 training and the C++ prefetcher ([16]). Serving: ten
# members of [5]'s model (8-stage UNet, bf16 trunk and head, 256^2, K=21),
# each initialised from its own seed, saved as member_i.ckpt and loaded by
# runner.run's eval-only path; [5]'s 6 views at T_a=25 (T_e = 10 members).
# Training: [9]'s configuration with task.train_ensemble=2 (one epoch per
# member) and with task.model.dtype=bfloat16 (3 epochs, no predict).
ENSEMBLE_MEMBERS = 10
ENSEMBLE_PASSES = 2  # timed passes over the test views after the first
ENSEMBLE_PROFILE_VIEWS = 2  # views of the profiled pass (the idle share's)
ENSEMBLE_DIR = Path("outputs") / "chip_smoke_ensemble"  # git-ignored, removed at the end
ENSEMBLE_SERVE_OVERRIDES = [
    "data=synthetic", f"data.n_patients={MAIN_CFG['n_patients']}",
    f"data.image_size={MAIN_CFG['size']}", "task=dsnt-al", "task/model=unet2",
    "task.model.drop_block=true", "task.model.dtype=bfloat16", f"task.t_a={MAIN_CFG['t_a']}",
    f"seed={MAIN_CFG['seed']}", "train=false", f"weights={ENSEMBLE_DIR / 'members'}",
    f"save_path={ENSEMBLE_DIR / 'serve'}", f"task.psm_path={ENSEMBLE_DIR / 'psm.npz'}",
    f"data.results_processors=[{', '.join(PROCESSOR_NAMES)}]",
]
_OWN = ("trainer.max_epochs=", "trainer.save_every=", "save_path=", "task.psm_path=")
ENSEMBLE_TRAIN_OVERRIDES = [o for o in TRAIN_OVERRIDES if not o.startswith(_OWN)] + [
    "task.train_ensemble=2", "trainer.max_epochs=1", "trainer.save_every=1",
    f"save_path={ENSEMBLE_DIR / 'train'}", f"task.psm_path={ENSEMBLE_DIR / 'train_psm.npz'}"]
BF16_TRAIN_OVERRIDES = [o for o in TRAIN_OVERRIDES if not o.startswith(_OWN)] + [
    "task.model.dtype=bfloat16", f"trainer.max_epochs={TRAIN_CFG['epochs']}",
    f"trainer.save_every={TRAIN_CFG['epochs']}", "predict=false",
    f"save_path={ENSEMBLE_DIR / 'bf16'}", f"task.psm_path={ENSEMBLE_DIR / 'bf16_psm.npz'}"]
# The RowMoments gradient of bf16 logits against autograd of the plain
# version in f64, relative to the largest: the adjoint computes in f32 and
# rounds its result to bf16 once (up to 2^-9 of an element), the f32
# softmax and the cancellation in (B g - sum p B g) add the rest (2.7e-3 on
# the CPU at 84 heatmaps of 64^2).
BF16_GRAD_BAR = 2.0 ** -8
# One bf16 train step (64^2, 4 stages, SGD) on the card and on the CPU, each
# against the model computing in f64: the relative L2 error of all
# gradients, plain and pinned to the step's own LeakyReLU sides. The bars
# are those of tests/test_torch_port_train_extras.py (CPU, five seeds:
# 0.14-0.23 plain, 0.024-0.05 pinned, from ~26,000 kink flips of 3.8M).
BF16_STEP_BARS = {"grad_l2": 0.35, "grad_l2_pinned": 0.1}


@contextmanager
def recording(cls, name: str, record):
    """While the block runs, `cls.name` calls record(args) before itself."""
    original = getattr(cls, name)

    def wrapper(*args, **kwargs):
        record(args)
        return original(*args, **kwargs)

    setattr(cls, name, wrapper)
    try:
        yield
    finally:
        setattr(cls, name, original)


def ensemble_members(task, n: int):
    """n members of the task's model on the card: one CPU-seeded
    initialisation, copied, each copy re-initialised from its own seed on
    the card."""
    import copy

    import torch

    base = task.build_model(device="cuda", generator=torch.Generator().manual_seed(0))
    members = []
    for i in range(n):
        member = copy.deepcopy(base)
        member.reset_parameters(torch.Generator(device="cuda").manual_seed(1000 + i))
        members.append(member.eval())
    return members


def ensemble_serving(main_res: dict, profile_dir=None) -> dict:
    """[5]'s model as an ensemble of ENSEMBLE_MEMBERS: saved with
    save_checkpoint as member_0.ckpt ... in one directory and served by
    runner.run's eval-only path (the test pass on member 0, [5]'s 6 views,
    the five processors; launches per call counted: K2 1 and K3 1 per view
    and per test batch); then the members loaded as runner.load_weights
    loads them, with [5]'s bf16 head, served over the same views (timed,
    profiled) at V=1 and V=4; each member's logits in the ensemble
    bitwise its own T_e=1 forward's, and its mu and cov in the ensemble
    and in its own forward both against the f64 moments of those logits
    within DSNT_BARS (the two heads sum in another order: the ensemble's
    420 heatmaps take one K2 block each, a member's 42 are split into
    bands); the skew task's ensemble on one view (K3 3)."""
    import copy

    import torch

    from contouring_uncertainty_torch import runner
    from contouring_uncertainty_torch.ops import dsnt_kernel
    from contouring_uncertainty_torch.ops.dsnt import raw6_to_pixel_gaussians
    from contouring_uncertainty_torch.tasks import DSNTAleatoric, DSNTSkew
    from contouring_uncertainty_torch.tasks.dsnt_al import forward_views
    from contouring_uncertainty_torch.train.checkpoint import save_checkpoint

    c = MAIN_CFG
    data = main_res["data"]
    shutil.rmtree(ENSEMBLE_DIR, ignore_errors=True)
    bf16 = dict(drop_block=True, dtype="bfloat16", head_dtype="bfloat16")
    task = DSNTAleatoric(data_params=data.data_params, t_a=c["t_a"], model_kwargs=bf16)
    t0 = time.perf_counter()
    members = ensemble_members(task, ENSEMBLE_MEMBERS)
    for i, member in enumerate(members):
        save_checkpoint(ENSEMBLE_DIR / "members" / f"member_{i}.ckpt",
                        {"params": member.state_dict()}, meta={"task_name": task.task_name})
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    with launch_ledger() as ledger:
        result = runner.run(ENSEMBLE_SERVE_OVERRIDES)
    torch.cuda.synchronize()
    runner_s = time.perf_counter() - t0
    for key in ("processor_errors", "test_error"):
        if key in result:
            raise AssertionError(f"the ensemble's eval-only run: {key} {result[key]}")
    check_gaussian_results(result["predict"], t_e=ENSEMBLE_MEMBERS)
    for label, calls in (("predict view", ledger["predict view"]),
                         ("val/test batch", ledger["val/test batch"])):
        if not calls or any(call != (1, 0, 1) for call in calls):
            raise AssertionError(f"ensemble {label}: launches (K2, K1, K3) {calls}")

    t0 = time.perf_counter()
    loaded = runner.load_weights(task, ENSEMBLE_DIR / "members", torch.device("cuda"))
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = {"seed": c["seed"]}
    run = serve(task, loaded, data, cfg, ENSEMBLE_PASSES,
                profile_dir / "ensemble" if profile_dir is not None else None,
                profile_views=ENSEMBLE_PROFILE_VIEWS)
    check_gaussian_results(run["results"], t_e=ENSEMBLE_MEMBERS)
    if run["launches"] != {"K2": run["views"], "K1": 0, "K3": run["views"]}:
        raise AssertionError(f"ensemble serving launches {run['launches']}")
    batched = serve(task, loaded, data, {**cfg, "predict_batch_views": BATCH_VIEWS}, 1,
                    profile_views=BATCH_VIEWS)
    if any(d != (1, 0, 1) for d in batched["per_dispatch"]):
        raise AssertionError(f"ensemble at V={BATCH_VIEWS}: launches {batched['per_dispatch']}")

    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = torch.as_tensor(run["results"][0].img, device="cuda")
    n, size = img.shape[0], c["size"]
    worst = {head: {"mu_px": 0.0, "sigma_rel": 0.0} for head in ("ensemble", "own")}
    worst["ensemble_vs_own"] = {"mu_px": 0.0, "cov_px2": 0.0}
    with torch.inference_mode():
        mu, cov = task.predict(loaded, img)
        ens_logits = forward_views(loaded, img, ENSEMBLE_MEMBERS, None)["out"]
        for e, member in enumerate(loaded):
            own_logits = member(img)["out"]
            if not torch.equal(ens_logits[e * n:(e + 1) * n], own_logits):
                raise AssertionError(f"member {e}'s logits in the ensemble are not its own")
            mu_e, cov_e = task.predict(member, img)
            raw = dsnt_kernel.raw_moments_plain(own_logits.reshape(-1, size * size).double(),
                                                size, size)
            mu_r, sig_r = raw6_to_pixel_gaussians(raw[:, :6], size, size)
            for head, (m, v) in {"ensemble": (mu[:, e], cov[:, e]),
                                 "own": (mu_e[:, 0], cov_e[:, 0])}.items():
                err = gaussian_errors(m.reshape(-1, 2), v.reshape(-1, 2, 2), mu_r, sig_r)
                worst[head] = {k: max(worst[head][k], err[k]) for k in err}
            diff = {"mu_px": (mu[:, e] - mu_e[:, 0]).abs().max().item(),
                    "cov_px2": (cov[:, e] - cov_e[:, 0]).abs().max().item()}
            worst["ensemble_vs_own"] = {k: max(worst["ensemble_vs_own"][k], diff[k])
                                        for k in diff}
    if not (within_dsnt_bars(worst["ensemble"]) and within_dsnt_bars(worst["own"])):
        raise AssertionError(f"ensemble members' moments outside {DSNT_BARS} of f64: {worst}")
    with torch.inference_mode():
        logits = served_logits({"results": run["results"], "model": loaded}, ENSEMBLE_MEMBERS)
    k2 = k2_reading(logits.reshape(-1, c["size"] ** 2), c["size"])
    samples = torch.as_tensor(run["results"][0].contour_samples, device="cuda")
    from contouring_uncertainty_torch.ops.spline import contour_spline

    dense = contour_spline(samples.reshape(-1, c["k"], 2), n=1024).contiguous()
    k3 = k3_reading(dense, c["size"], f"one ensemble view's sampled contours ({dense.shape[0]})")

    checks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    skew_task = DSNTSkew(data_params=data.data_params, t_a=c["t_a"], model_kwargs=bf16)
    skew_base = skew_task.build_model(device="cuda", generator=torch.Generator().manual_seed(0))
    skew_members = []
    for member in loaded:
        skew_member = copy.deepcopy(skew_base)
        skew_member.unet.load_state_dict(member.state_dict())
        skew_members.append(skew_member.eval())
    skew = serve(skew_task, skew_members, FirstViews(data, 1),
                 {"seed": c["seed"], "task": {"skew_method": "esn", "grid_window": 64}}, 0)
    if skew["launches"] != {"K2": 1, "K1": 0, "K3": 3}:
        raise AssertionError(f"skew ensemble on one view: launches {skew['launches']}")
    if not all(np.isfinite(getattr(skew["results"][0], k)).all() for k in ("mu", "cov", "alpha")):
        raise AssertionError("skew ensemble: non-finite mu, cov or alpha")
    return {"setup_s": setup_s, "runner_s": runner_s, "load_s": load_s, "serve_s": serve_s,
            "first_s": run["first_s"], "profile_s": run["profile_s"],
            "batched_s": batched["first_s"] + sum(batched["pass_s"]), "checks_s": checks_s,
            "skew_s": time.perf_counter() - t0, "run": run, **rate(run, run["pass_s"]),
            "runner_calls": {k: len(v) for k, v in ledger.items()},
            "batched": {"per_dispatch": batched["per_dispatch"],
                        **rate(batched, batched["pass_s"] or [batched["first_s"]])},
            "member_worst": worst, "k2": k2, "k3": k3, "skew_launches": skew["launches"],
            "test": result.get("test_metrics", {})}


def ensemble_training() -> dict:
    """runner.run with task.train_ensemble=2 at [9]'s configuration, one
    epoch per member: JAX's layout (member_0.ckpt, member_1.ckpt under
    <save_path>/<seed>/<name>_ensemble), every loss finite, launches per
    call as [9]'s, every batch from the prefetch library, and the test
    views predicted at T_e=2 with the five processors and no error."""
    import torch

    from contouring_uncertainty_torch import runner
    from contouring_uncertainty_torch.data import native_loader

    native_loader.batches_served = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with launch_ledger() as ledger, epilogue_ledger() as epi:
        result = runner.run(ENSEMBLE_TRAIN_OVERRIDES)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    ens = Path(result["ckpt_path"])
    if sorted(p.name for p in ens.iterdir()) != ["member_0.ckpt", "member_1.ckpt"] or not all(
            (ens / f"member_{i}.ckpt" / "state.pt").exists() for i in range(2)):
        raise AssertionError(f"ensemble directory {ens}: {sorted(ens.iterdir())}")
    if ens.name != "synthetic_dsnt-al-unet2-True_0_ensemble" or ens.parent.name != "0":
        raise AssertionError(f"ensemble directory {ens} is not the JAX runner's")
    if "processor_errors" in result or "test_error" in result:
        raise AssertionError(f"ensemble training run: {result.get('processor_errors')} "
                             f"{result.get('test_error')}")
    for row in result["history"]:
        if not all(np.isfinite(v) for v in row.values()):
            raise AssertionError(f"non-finite ensemble training log: {row}")
    for res in result["predict"]:
        if res.contour_samples.shape[1] != 2 or not np.isfinite(res.mu).all():
            raise AssertionError(f"ensemble predict: {res.contour_samples.shape}")
    expected = {"train step": (1, 0, 0), "val/test batch": (1, 0, 1), "predict view": (1, 0, 1)}
    for label, calls in ledger.items():
        if not calls or any(call != expected[label] for call in calls):
            raise AssertionError(f"ensemble training {label}: launches {calls}")
    feed = native_feed(len(ledger["train step"]))
    epilogue = epilogue_per_step("ensemble training", epi, layers=UNET2_LAYERS)
    # Each member's steps as its PhaseTimer took them, its first left out.
    steps = []
    for i in range(2):
        cfg_i = f"{ens.name[:-len('_0_ensemble')]}_{i}"
        phases = json.loads((ens.parent.parent / str(i) / f"{cfg_i}_phases.json").read_text())
        steps += phases["train_step"]["samples_ms"][1:]
    steps.sort()
    return {"wall_s": wall_s, "history": result["history"], "views": len(result["predict"]),
            "step_ms": steps[len(steps) // 2], "step_ms_range": (steps[0], steps[-1]),
            "calls": {k: len(v) for k, v in ledger.items()}, "per_call": expected,
            "epilogue": epilogue, "feed": feed,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def bf16_training() -> dict:
    """runner.run at [9]'s configuration with task.model.dtype=bfloat16, 3
    epochs: every loss finite (whether it falls is a reading), ms/step and
    images/s, peak memory, launches per call (K2 1 per train step on the
    head's f32 logits), every batch from the prefetch library and the first
    epoch's batches in the order the same library gives on the host."""
    import torch

    from contouring_uncertainty_torch import runner
    from contouring_uncertainty_torch.data import native_loader
    from contouring_uncertainty_torch.data.config import Tags
    from contouring_uncertainty_torch.data.native_loader import NativePrefetcher
    from contouring_uncertainty_torch.train import Trainer

    shutil.rmtree(ENSEMBLE_DIR / "bf16", ignore_errors=True)
    native_loader.batches_served = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fed, fits = [], []
    t0 = time.perf_counter()
    with launch_ledger() as ledger, epilogue_ledger() as epi, \
            recording(Trainer, "fit", fits.append), \
            recording(Trainer, "train_step",
                      lambda args: fed.append(args[1][Tags.contour].cpu().numpy())):
        result = runner.run(BF16_TRAIN_OVERRIDES)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    history = result["history"]
    if len(history) != TRAIN_CFG["epochs"] or not all(
            np.isfinite(v) for row in history for v in row.values()):
        raise AssertionError(f"bf16 training log: {history}")
    expected = {"train step": (1, 0, 0), "val/test batch": (1, 0, 1)}
    for label, want in expected.items():
        if not ledger[label] or any(call != want for call in ledger[label]):
            raise AssertionError(f"bf16 training {label}: launches {ledger[label]}")
    # The norm chains op by op; the trunk's 1x1s compute in bf16 (no kernel),
    # the head's output convolution in f32 (the kernel, once a step).
    epilogue = epilogue_per_step("bf16 training", epi, layers=0, wgrad=1)
    feed = native_feed(len(ledger["train step"]))
    # The library's first epoch on the host, over sample indices.
    trainer, train, val = fits[0][:3]
    n = len(train[Tags.img])
    index = {Tags.img: np.arange(n, dtype=np.float32).reshape(n, 1, 1, 1)}
    prefetcher = NativePrefetcher(index, TRAIN_CFG["batch"], seed=TRAIN_CFG["seed"])
    order = [b[Tags.img].ravel().astype(int) for b in prefetcher.epoch()]
    prefetcher.close()
    if len(order) != len(fed) // TRAIN_CFG["epochs"] or not all(
            np.array_equal(train[Tags.contour][idx], got) for idx, got in zip(order, fed)):
        raise AssertionError("the card's first epoch is not the library's order on the host")
    name = Path(result["ckpt_path"]).name[:-len(".ckpt")]
    phases = json.loads((Path(result["ckpt_path"]).parent / f"{name}_phases.json").read_text())
    steps = phases["train_step"]["samples_ms"]
    later = sorted(steps[len(steps) // TRAIN_CFG["epochs"]:])
    median_ms = later[len(later) // 2]
    return {"history": history, "losses": [row["train/loss"] for row in history],
            "test": result.get("test_metrics", {}), "wall_s": wall_s, "peak_gib": peak_gib,
            "step_ms": median_ms, "step_ms_range": (later[0], later[-1]),
            "images_per_s": TRAIN_CFG["batch"] / median_ms * 1e3, "feed": feed,
            "first_epoch_batches": len(order), "data_wait": data_wait(phases),
            "calls": {k: len(v) for k, v in ledger.items()}, "per_call": expected,
            "epilogue": epilogue, "trainer": trainer, "val": val}


def bf16_kernel_checks(trainer, val) -> dict:
    """On one validation batch's head logits of the bf16-trained model (its
    last weights; 672 heatmaps of 256^2, cast to bf16): K2 against f64 at the bars of
    [3], and the RowMoments gradient of the bf16 logits (the adjoint in
    f32, rounded to bf16 once) against autograd of the plain version in
    f64 within BF16_GRAD_BAR; the forward and the backward timed beside
    their byte bounds."""
    import torch

    from contouring_uncertainty_torch.data.config import Tags
    from contouring_uncertainty_torch.ops import dsnt_kernel

    size = MAIN_CFG["size"]
    img = torch.as_tensor(val[Tags.img][:TRAIN_CFG["batch"]], device="cuda")
    trainer.model.eval()
    with torch.no_grad():
        logits = trainer.model(img)["out"]
    if logits.dtype != torch.float32:
        raise AssertionError(f"the bf16 model's head gives {logits.dtype} logits, not f32")
    rows = logits.reshape(-1, size * size).to(torch.bfloat16)
    k2 = k2_reading(rows, size)
    g = torch.as_tensor(np.random.default_rng(4).normal(size=(rows.shape[0], 8))
                        .astype(np.float32), device="cuda")
    leaf = rows.clone().requires_grad_()
    (grad,) = torch.autograd.grad(dsnt_kernel.dsnt_raw_moments(leaf, size, size), leaf, g)
    xd = rows.double().requires_grad_()
    dsnt_kernel.raw_moments_plain(xd, size, size).backward(g.double())
    grad_err = ((grad.double() - xd.grad).abs().max() / xd.grad.abs().max()).item()
    del xd
    if grad.dtype != torch.bfloat16 or grad_err > BF16_GRAD_BAR:
        raise AssertionError(f"RowMoments bf16 gradient {grad.dtype}, off by {grad_err} "
                             f"(bar {BF16_GRAD_BAR})")
    bwd_ms = cuda_ms(lambda: dsnt_kernel.moments_adjoint(rows, g, size, size), iters=5)
    r, hw = rows.shape
    bwd_bound = {"bytes": (2 * r * hw * 2 + r * 8 * 4) / HBM_BYTES_PER_S * 1e3,
                 "operations": r * hw * 24 / F32_OPS_PER_S * 1e3}
    torch.cuda.empty_cache()
    return {"k2": k2, "grad_rel_err": grad_err, "grad_dtype": str(grad.dtype),
            "bwd_ms": bwd_ms, "bwd_bound_ms": max(bwd_bound.values()),
            "bwd_bound_by": max(bwd_bound, key=bwd_bound.get)}


def bf16_step_check() -> dict:
    """One bf16 SGD step (64^2, 4 stages, drop_block and augmentation off,
    the same seeded weights and batch) on the card and on the CPU, each
    against the model computing in f64 (`set_compute_dtype`), plainly and
    pinned to the step's own LeakyReLU sides (`leaky_relu_sides`): the
    relative L2 error of all gradients (conv biases ahead of a norm left
    out) within BF16_STEP_BARS; every trunk convolution emits bf16 and the
    head f32 (`conv_output_dtypes`); kink flips counted; card against CPU
    a reading."""
    import torch

    from contouring_uncertainty_torch.data.config import DataParams, Tags
    from contouring_uncertainty_torch.data.synthetic import make_arrays
    from contouring_uncertainty_torch.models.layers import conv_output_dtypes, set_compute_dtype
    from contouring_uncertainty_torch.models.unet import leaky_relu_sides
    from contouring_uncertainty_torch.tasks import DSNTAleatoric
    from contouring_uncertainty_torch.train import Trainer, TrainerConfig

    imgs, gts, contours = make_arrays(8, size=64, seed=2)
    task = DSNTAleatoric(
        data_params=DataParams(in_shape=(1, 64, 64), out_shape=(21, 2)),
        model_kwargs=dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3,
                          drop_block=False, dtype="bfloat16"))
    cfg = TrainerConfig(optimizer="sgd", augment=False, seed=5)

    def batch_on(device, dtype=torch.float32):
        return {Tags.img: torch.as_tensor(imgs, device=device, dtype=dtype),
                Tags.gt: torch.as_tensor(gts, device=device),
                Tags.contour: torch.as_tensor(contours, device=device, dtype=dtype)}

    def one_step(device):
        trainer = Trainer(task, cfg, device=device)
        trainer.init_state()
        with leaky_relu_sides(trainer.model) as sides, \
                conv_output_dtypes(trainer.model) as conv_dtypes:
            loss = float(trainer.train_step(batch_on(device), 0)["loss"])
        if not conv_dtypes or any(
                dt != (torch.float32 if n.startswith("OutputBlock") else torch.bfloat16)
                for n, dt in conv_dtypes.items()):
            raise AssertionError(f"bf16 step on {device}: convolutions emit {conv_dtypes}")
        return loss, {n: p.grad.detach().cpu().double() for n, p in
                      trainer.model.named_parameters()}, {n: s.cpu() for n, s in sides.items()}

    def f64_step(pin=None):
        model64 = set_compute_dtype(task.build_model(
            device="cpu", generator=torch.Generator().manual_seed(cfg.seed)).double(),
            torch.float64)
        with leaky_relu_sides(model64, pin) as sides:
            loss = task.loss(model64, batch_on("cpu", torch.float64), train=True)[0]
            loss.backward()
        return float(loss.detach()), {n: p.grad for n, p in model64.named_parameters()}, sides

    steps = {"cpu": one_step("cpu"), "card": one_step("cuda")}
    loss64, ref, sides64 = f64_step()
    leaves = [n for n in ref if not n.endswith("Conv_0.bias")]

    def l2(a, b):
        num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in leaves)
        return (num / sum(float((b[n] ** 2).sum()) for n in leaves)) ** 0.5

    out = {"loss_f64": loss64}
    for name, (loss, grads, sides) in steps.items():
        out[name] = {"loss": loss, "grad_l2": l2(grads, ref),
                     "grad_l2_pinned": l2(grads, f64_step(sides)[1]),
                     "kink_flips": sum(int((sides[n] != sides64[n]).sum()) for n in sides64)}
        if any(out[name][k] > bar for k, bar in BF16_STEP_BARS.items()):
            raise AssertionError(f"bf16 step on the {name}: {out[name]} (bars {BF16_STEP_BARS})")
    out["card_vs_cpu_l2"] = l2(steps["card"][1], steps["cpu"][1])
    out["activations"] = sum(s.numel() for s in sides64.values())
    return out


# Several ranks ([17]): two ranks spawned on the one card through
# parallel/distributed.py `spawn` over gloo (NCCL refuses two ranks on one
# GPU), each driving (a) three data-parallel SGD steps of [9]'s model and
# global batch, (b) view-parallel run_predict of 8 views at [5]'s
# configuration (13 synthetic patients), (c) one view in the latency mode on
# a 1 x 2 mesh (predict_sample_parallel=2: each rank its block of the
# MC-dropout tail's rows, K2 on its heatmaps, its T_a share through the
# sampler and K3) and one view of [12]'s mcdropout through SegPredictor on
# the same mesh, against one process on the card; (d) four ranks' shards of
# a view taken in this process (two of them empty). SGD, not [9]'s AdamW, for
# the reason gpu_vs_cpu_step gives. Bars: (a) each leaf's update within
# STEP_BARS["grad_leaf"] of the leaf's largest plus STEP_BARS["zero_grad"]
# of the largest of all (the conv biases ahead of an instance norm: rounding
# noise), the step losses within 1e-4 relative; (b) every output bitwise;
# (c) the JAX package's latency-mode budgets (tests/test_parallel.py) and,
# as (b), every output bitwise, the mcdropout view's too; (d) bitwise.
MULTI_CFG = dict(steps=3, lr=1e-2, views_patients=13, views=8, seed=0)
LATENCY_BARS = {"mu": 1e-4, "cov": 1e-4, "samples_q80": 2.5e-2, "samples_max": 3.5,
                "pred_share": 1e-2, "entropy_mean": 0.03}


def digest(a) -> str:
    import hashlib

    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.shape} {a.dtype}".encode() + a.tobytes()).hexdigest()


def ddp_steps() -> dict:
    """MULTI_CFG["steps"] SGD steps of [9]'s model (8 stages, drop_block, f32)
    on a global batch of 32 256^2 frames (each step its own augmentation
    and dropout draws), through `Trainer.train_step` on every rank of the
    process group (one process without one) -> each leaf's update, the step
    losses (this rank's rows) and the final weights' digest."""
    import torch

    from contouring_uncertainty_torch.data.config import DataParams
    from contouring_uncertainty_torch.data.synthetic import make_arrays
    from contouring_uncertainty_torch.tasks import DSNTAleatoric
    from contouring_uncertainty_torch.train import Trainer, TrainerConfig
    from contouring_uncertainty_torch.train.trainer import _to_device

    c = MULTI_CFG
    b = TRAIN_CFG["batch"]
    imgs, gts, contours = make_arrays(b, size=256, seed=c["seed"])
    task = DSNTAleatoric(data_params=DataParams(in_shape=(1, 256, 256), out_shape=(21, 2)),
                         model_kwargs=dict(drop_block=True))
    trainer = Trainer(task, TrainerConfig(batch_size=b, lr=c["lr"], optimizer="sgd",
                                          seed=c["seed"], augment=True), device="cuda")
    trainer.init_state()
    p0 = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    batch = _to_device({"img": imgs, "gt": gts, "contour": contours}, torch.device("cuda"))
    losses = [float(trainer.train_step(batch, step)["loss"]) for step in range(c["steps"])]
    state = trainer.model.state_dict()
    return {"updates": {k: (state[k] - p0[k]).cpu().numpy() for k in state},
            "losses": losses, "mesh": trainer.mesh.shape,
            "digest": digest(np.concatenate([v.cpu().numpy().ravel() for v in state.values()]))}


def multi_serving_setup():
    """[5]'s task and model (its seed) and the 8 test views of 13 patients."""
    import torch

    from contouring_uncertainty_torch.tasks import DSNTAleatoric

    c = MAIN_CFG
    data = camus_data(MULTI_CFG["views_patients"], c["size"], c["seed"])
    task = DSNTAleatoric(
        data_params=data.data_params, t_e=c["t_e"], t_a=c["t_a"], covar=True,
        model_kwargs=dict(drop_block=True, dtype="bfloat16", head_dtype="bfloat16"))
    model = task.build_model(device="cuda", generator=torch.Generator().manual_seed(c["seed"]))
    return task, model, data


def served_digests(setup, mesh, timed: bool = False) -> dict:
    """run_predict of the 8 views of `setup` (multi_serving_setup) on
    `mesh` (None: this process alone) -> each view's outputs as digests
    (rank 0; None on other ranks), the first pass's seconds and, `timed`, a
    second pass's views/s."""
    import torch

    from contouring_uncertainty_torch.predict import run_predict

    task, model, data = setup
    t0 = time.perf_counter()
    results = run_predict(task, model, data, {"seed": MAIN_CFG["seed"]}, mesh=mesh)
    torch.cuda.synchronize()
    out = {"first_s": time.perf_counter() - t0, "views": None}
    if results:
        if len(results) != MULTI_CFG["views"]:
            raise AssertionError(f"{len(results)} views served, expected {MULTI_CFG['views']}")
        check_gaussian_results(results)
        keys = ("mu", "cov", "post_mu", "post_cov", "contour_samples", "pred_samples", "pred",
                "uncertainty_map", "entropy_map")
        out["views"] = {r.id: {k: digest(getattr(r, k)) for k in keys} for r in results}
    if timed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_predict(task, model, data, {"seed": MAIN_CFG["seed"]}, mesh=mesh)
        torch.cuda.synchronize()
        out["views_per_s"] = MULTI_CFG["views"] / (time.perf_counter() - t0)
    return out


@contextmanager
def split_recording(model):
    """Within the block: the rows of each call of `model`'s stochastic tail
    (its first dropout stage), the (rows, bands) of each K2 launch and the
    contours of each K3 launch (the launch wrappers wrapped, their counts
    untouched)."""
    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel

    rec = {"tail": [], "k2": [], "k3": []}
    unet = getattr(model, "unet", model)
    handle = unet.stage(unet.first_drop + 1).register_forward_hook(
        lambda mod, inputs, out: rec["tail"].append(inputs[0].shape[0]))
    k2, k3 = dsnt_kernel.raw_moments_cuda, select_kernel.min_k_crossings_kernel

    def k2_rec(x2d, height, width, bands=None):
        rec["k2"].append((x2d.shape[0], bands))
        return k2(x2d, height, width, bands)

    def k3_rec(dense, height, overflow_rows=None):
        rec["k3"].append(dense.shape[0])
        return k3(dense, height, overflow_rows)

    dsnt_kernel.raw_moments_cuda, select_kernel.min_k_crossings_kernel = k2_rec, k3_rec
    try:
        yield rec
    finally:
        dsnt_kernel.raw_moments_cuda, select_kernel.min_k_crossings_kernel = k2, k3
        handle.remove()


def output_digests(out: dict, prefix: str = "") -> dict:
    """Every output of a predictor's dict (nested dicts flattened) as its
    digest; None stays None."""
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(output_digests(v, f"{prefix}{k}/"))
        else:
            flat[prefix + k] = None if v is None else digest(v)
    return flat


def latency_view(setup, mesh) -> dict:
    """The first test view of `setup` through AleatoricPredictor on `mesh`
    (None: this process alone), its draws from view_generator(seed, 0) ->
    numpy outputs (the sample masks as a digest), every output's digest,
    and the rows each tail call, K2 launch and K3 launch took."""
    import torch

    from contouring_uncertainty_torch.predict import (
        AleatoricPredictor,
        _to_numpy,
        get_or_fit_prior,
        view_generator,
    )
    from contouring_uncertainty_torch.sampler import PosteriorShapeModelSampler

    task, model, data = setup
    sampler = PosteriorShapeModelSampler(get_or_fit_prior(data, None), device="cuda")
    view = next(iter(data.predict_views("test")))
    with split_recording(model) as rec:
        out = _to_numpy(AleatoricPredictor(task, model, sampler, device="cuda", mesh=mesh)(
            view["img"], view_generator(MAIN_CFG["seed"], 0)))
        torch.cuda.synchronize()
    keep = ("mu", "cov", "contour_samples", "pred", "entropy_map")
    return {**{k: out[k] for k in keep}, "pred_samples": digest(out["pred_samples"]),
            "digests": output_digests(out), "rows": rec}


def seg_setup(data):
    """[12]'s mcdropout task and model (8-stage UNet, bf16 trunk, T_e 10,
    T_a 1, [5]'s seed) on `data`."""
    import torch

    task = seg_task("mcdropout", data.data_params)
    model = task.build_model(device="cuda",
                             generator=torch.Generator().manual_seed(MAIN_CFG["seed"]))
    return task, model, data


def seg_latency_view(setup, mesh) -> dict:
    """The first test view of `setup` (seg_setup) through SegPredictor on
    `mesh` (None: this process alone) -> every output's digest and the
    rows each tail call took."""
    import torch

    from contouring_uncertainty_torch.predict import SegPredictor, _to_numpy, view_generator

    task, model, data = setup
    view = next(iter(data.predict_views("test")))
    with split_recording(model) as rec:
        out = _to_numpy(SegPredictor(task, model, device="cuda", mesh=mesh)(
            view["img"], view_generator(MAIN_CFG["seed"], 0)))
        torch.cuda.synchronize()
    return {"digests": output_digests(out), "rows": rec}


def rank_worker(device, timed: bool) -> dict:
    """One rank of [17]: (a) ddp_steps, (b) served_digests on make_mesh(),
    (c) latency_view and seg_latency_view on make_mesh(model_parallel=2),
    each with the kernels' launch counts set to 0 just before it and read
    just after."""
    import torch
    import torch.distributed as dist

    from contouring_uncertainty_torch.ops import conv_epilogue as ce
    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel
    from contouring_uncertainty_torch.parallel import distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": distributed.rank(), "world": distributed.world_size(),
           "device": str(device), "backend": dist.get_backend(),
           "card": torch.cuda.get_device_name(device)}
    setup = multi_serving_setup()
    seg = seg_setup(setup[2])
    for label, fn in (("train", ddp_steps),
                      ("serve", lambda: served_digests(setup, make_mesh(), timed)),
                      ("latency", lambda: latency_view(setup, make_mesh(model_parallel=2))),
                      ("seg_latency", lambda: seg_latency_view(seg, make_mesh(model_parallel=2)))):
        torch.cuda.synchronize()
        dsnt_kernel.row_launches = dsnt_kernel.col_launches = select_kernel.launches = 0
        ce.fwd_launches = ce.bwd_launches = 0
        t0 = time.perf_counter()
        out[label] = fn()
        torch.cuda.synchronize()
        out[label]["s"] = time.perf_counter() - t0
        out[label]["launches"] = {"K2": dsnt_kernel.row_launches,
                                  "K1": dsnt_kernel.col_launches, "K3": select_kernel.launches}
        out[label]["epilogue"] = {"forward": ce.fwd_launches, "backward": ce.bwd_launches}
    if out["rank"] != 0:
        out["train"].pop("updates")
    return out


def check_ranks(ranks: list, one: dict) -> dict:
    """The ranks of one spawn against one process: (a) (b) (c) at their
    bars, K2 and K3 launched in every rank on every path that runs them."""
    ref = one["train"]["updates"]
    floor = STEP_BARS["zero_grad"] * max(np.abs(u).max() for u in ref.values())
    worst = 0.0  # the largest share of its bar a leaf's error takes
    got = ranks[0]["train"]["updates"]
    for name, want in ref.items():
        err = float(np.abs(got[name] - want).max())
        bar = STEP_BARS["grad_leaf"] * float(np.abs(want).max()) + floor
        worst = max(worst, err / bar)
        if err > bar:
            raise AssertionError(f"[17] DDP update of {name} {err:.3e} from one process's "
                                 f"(leaf max {np.abs(want).max():.3e}, floor {floor:.3e})")
    if len({r["train"]["digest"] for r in ranks}) != 1:
        raise AssertionError("[17] the ranks ended the DDP steps with different weights")
    losses = np.mean([r["train"]["losses"] for r in ranks], axis=0)
    np.testing.assert_allclose(losses, one["train"]["losses"], rtol=1e-4,
                               err_msg="[17] DDP step losses")
    if ranks[0]["serve"]["views"] != one["serve"]["views"]:
        bad = [v for v, d in one["serve"]["views"].items()
               if ranks[0]["serve"]["views"].get(v) != d]
        raise AssertionError(f"[17] view-parallel outputs differ from one process's: {bad}")
    if any(r["serve"]["views"] is not None for r in ranks[1:]):
        raise AssertionError("[17] a rank other than 0 returned predictions")
    lat_err = {}
    for r in ranks:
        a, b = r["latency"], one["latency"]
        d = np.abs(a["contour_samples"] - b["contour_samples"])
        err = {"mu": float(np.abs(a["mu"] - b["mu"]).max()),
               "cov": float(np.abs(a["cov"] - b["cov"]).max()),
               "samples_q80": float(np.quantile(d, 0.8)), "samples_max": float(d.max()),
               "pred_share": float((a["pred"] != b["pred"]).mean()),
               "entropy_mean": float(np.abs(a["entropy_map"] - b["entropy_map"]).mean())}
        bad = {k: v for k, v in err.items() if not v < LATENCY_BARS[k]}
        if bad:
            raise AssertionError(f"[17] latency mode on rank {r['rank']} outside "
                                 f"{LATENCY_BARS}: {bad}")
        lat_err = {k: max(v, lat_err.get(k, 0.0)) for k, v in err.items()}
    for r in ranks:
        for label, kernels in (("train", ("K2",)), ("serve", ("K2", "K3")),
                               ("latency", ("K2", "K3"))):
            for k in kernels:
                if r[label]["launches"][k] < 1:
                    raise AssertionError(f"[17] rank {r['rank']} launched {k} "
                                         f"{r[label]['launches'][k]} times in {label}")
        want = {"forward": UNET2_LAYERS * MULTI_CFG["steps"],
                "backward": UNET2_LAYERS * MULTI_CFG["steps"]}
        if r["train"]["epilogue"] != want:
            raise AssertionError(f"[17] rank {r['rank']} launched the conv epilogue kernels "
                                 f"{r['train']['epilogue']} times in its DDP steps, expected "
                                 f"{want}")
        if any(r["seg_latency"]["launches"].values()):
            raise AssertionError(f"[17] rank {r['rank']} launched {r['seg_latency']['launches']}"
                                 " in the segmentation view (no K2, K1 or K3 there)")
        for label in ("latency", "seg_latency"):
            bad = [k for k, d in one[label]["digests"].items() if r[label]["digests"].get(k) != d]
            if bad or r[label]["digests"].keys() != one[label]["digests"].keys():
                raise AssertionError(f"[17] {label} on rank {r['rank']}: outputs differ from "
                                     f"one process's: {bad}")
    check_split_rows(ranks, one)
    return {"ddp_worst_share": worst, "latency_err": lat_err,
            "latency_samples_bitwise": lat_err["samples_max"] == 0.0}


def check_split_rows(ranks: list, one: dict) -> None:
    """What each rank of the latency mode ran against one process: its
    blocks of the MC-dropout tail's rows (one process all of them, in the
    same blocks), K2 once on its rows' heatmaps with the whole batch's band
    count, K3 once on its T_a share's contours; in the segmentation view
    its blocks of the tail."""
    from contouring_uncertainty_torch.ops.dsnt_kernel import row_bands
    from contouring_uncertainty_torch.parallel.serving import SampleShard

    c, n = MAIN_CFG, 2
    for label in ("latency", "seg_latency"):
        t_e = c["t_e"] if label == "latency" else SEG_CFG["mcdropout"]["t_e"]
        tail = one[label]["rows"]["tail"]
        block = tail[0]
        if sum(tail) != t_e * n or set(tail) != {block}:
            raise AssertionError(f"[17] one process's {label} tail ran rows {tail}")
        for r in ranks:
            part = SampleShard(None, r["rank"], len(ranks)).part(t_e * n, block)
            want = [block] * ((part.stop - part.start) // block)
            if r[label]["rows"]["tail"] != want:
                raise AssertionError(f"[17] rank {r['rank']}'s {label} tail ran rows "
                                     f"{r[label]['rows']['tail']}, expected {want}")
    whole = c["t_e"] * n * c["k"]
    bands = row_bands(whole, c["size"], c["size"], 2, n_sm())
    if one["latency"]["rows"]["k2"] != [(whole, None)]:  # the kernel's default: `bands`
        raise AssertionError(f"[17] one process's K2 launches {one['latency']['rows']['k2']}")
    for r in ranks:
        rows = sum(r["latency"]["rows"]["tail"]) * c["k"]
        share = SampleShard(None, r["rank"], len(ranks)).part(c["t_a"])
        contours = n * c["t_e"] * (share.stop - share.start)
        if r["latency"]["rows"]["k2"] != [(rows, bands)] or \
                r["latency"]["rows"]["k3"] != [contours]:
            raise AssertionError(f"[17] rank {r['rank']}: K2 launches (rows, bands) "
                                 f"{r['latency']['rows']['k2']} (expected {[(rows, bands)]}), "
                                 f"K3 contours {r['latency']['rows']['k3']} (expected "
                                 f"{[contours]})")


def empty_shares_check(setup) -> dict:
    """(d) More ranks than blocks or samples, on the card in this process:
    the shards of four ranks taken one after another on [5]'s first test
    view (T_e = 10: two tail blocks, ranks 2 and 3 none; T_a = 2: ranks 2
    and 3 no sample). Each rank's tail rows and samples, concatenated in
    rank order, must be bitwise one process's, and every rank must leave
    the view's generator where one process leaves it; the DSNT head and the
    rasterizer of a rank with no share launch no K2 and no K3."""
    import torch

    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel
    from contouring_uncertainty_torch.ops.dsnt import logits_to_pixel_gaussians
    from contouring_uncertainty_torch.parallel.serving import SampleShard
    from contouring_uncertainty_torch.predict import (
        get_or_fit_prior,
        rasterize_labelmap,
        view_generator,
    )
    from contouring_uncertainty_torch.sampler import PosteriorShapeModelSampler
    from contouring_uncertainty_torch.tasks.dsnt_al import mc_dropout_apply

    c, k, t_a = MAIN_CFG, 4, 2
    task, model, data = setup
    sampler = PosteriorShapeModelSampler(get_or_fit_prior(data, None), device="cuda")
    img = torch.as_tensor(next(iter(data.predict_views("test")))["img"], device="cuda")
    shards = [SampleShard(None, i, k) for i in range(k)]
    with torch.inference_mode():
        g = view_generator(c["seed"], 0)
        whole = mc_dropout_apply(model, img, c["t_e"], g)["out"]
        after = g.get_state()
        tails, moved = [], []
        for shard in shards:
            g = view_generator(c["seed"], 0)
            tails.append(mc_dropout_apply(model, img, c["t_e"], g, shard)["out"])
            moved.append(not torch.equal(g.get_state(), after))
        mu, cov = logits_to_pixel_gaussians(whole.unflatten(0, (c["t_e"], -1)).transpose(0, 1))
        g = view_generator(c["seed"], 0)
        samples = sampler.sample_batch([g], mu[None], cov[None], n=t_a)
        after = g.get_state()
        parts = []
        for shard in shards:
            g, share = view_generator(c["seed"], 0), shard.part(t_a)
            parts.append(sampler.sample_batch(shard.row_blocks([g], t_a, axis=1), mu[None],
                                              cov[None], n=share.stop - share.start))
            moved.append(not torch.equal(g.get_state(), after))
        k2, k3 = dsnt_kernel.row_launches, select_kernel.launches
        empty_head = logits_to_pixel_gaussians(tails[-1], whole_rows=whole.shape[0] * c["k"])
        empty_masks = rasterize_labelmap(parts[-1], [(0, c["k"], 1)], c["size"], c["size"])
        torch.cuda.synchronize()
        launched = (dsnt_kernel.row_launches - k2, select_kernel.launches - k3)
    out = {"tail_rows": [t.shape[0] for t in tails], "samples": [p.shape[-3] for p in parts],
           "tail_bitwise": torch.equal(torch.cat(tails), whole),
           "samples_bitwise": torch.equal(torch.cat(parts, dim=-3), samples),
           "generators_moved": sum(moved), "empty_launches": launched,
           "empty_shapes": [tuple(empty_head[0].shape), tuple(empty_masks.shape)]}
    if out["tail_rows"] != [10, 10, 0, 0] or out["samples"] != [1, 1, 0, 0] \
            or not out["tail_bitwise"] or not out["samples_bitwise"] \
            or out["generators_moved"] or launched != (0, 0):
        raise AssertionError(f"[17] (d) shares of four ranks: {out}")
    return out


def nccl_world_of_one() -> float:
    """NCCL initialised at world size 1 in this process (a file://
    rendezvous), one all-reduce on the card, then destroyed -> its value."""
    import tempfile

    import torch
    import torch.distributed as dist

    from contouring_uncertainty_torch.parallel import distributed

    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(f"file://{tmp}/rendezvous", 1, 0, backend="nccl",
                               device="cuda:0", timeout_s=120)
        try:
            x = torch.ones(4, device="cuda")
            dist.all_reduce(x)
            return float(x.sum().item())
        finally:
            dist.destroy_process_group()


def multi_rank_phase() -> dict:
    """[17]: one process's (a) (b) (c) on the card, two gloo ranks on it, (d),
    with two or more cards the NCCL ranks one per card and views/s on one
    card against two, NCCL at world size 1; K3 at one rank's share of a
    view in the latency mode."""
    import torch

    from contouring_uncertainty_torch.ops.spline import contour_spline
    from contouring_uncertainty_torch.parallel import distributed
    from contouring_uncertainty_torch.parallel.serving import SampleShard
    from contouring_uncertainty_torch.predict import view_generator
    from contouring_uncertainty_torch.tasks.dsnt_al import forward_views

    n_cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    setup = multi_serving_setup()
    one = {"train": ddp_steps(), "serve": served_digests(setup, None, timed=n_cards >= 2),
           "latency": latency_view(setup, None),
           "seg_latency": seg_latency_view(seg_setup(setup[2]), None)}
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gloo = distributed.spawn(rank_worker, 2, backend="gloo", devices=["cuda:0", "cuda:0"],
                             args=(False,), deadline_s=600)
    gloo_s = time.perf_counter() - t0
    out = {"one_s": one_s, "gloo_s": gloo_s, "gloo": gloo, "one": one,
           "gloo_check": check_ranks(gloo, one)}
    if n_cards >= 2:
        t0 = time.perf_counter()
        nccl = distributed.spawn(rank_worker, 2, backend="nccl",
                                 devices=["cuda:0", "cuda:1"], args=(True,), deadline_s=600)
        out.update(nccl=nccl, nccl_s=time.perf_counter() - t0,
                   nccl_check=check_ranks(nccl, one))
    else:
        out["nccl_world_1"] = nccl_world_of_one()
        if out["nccl_world_1"] != 4.0:
            raise AssertionError(f"NCCL all-reduce at world size 1 gave {out['nccl_world_1']}")

    # K3 at rank 0's share of a view in the latency mode: tensor_split(T_a,
    # 2)[0] of each forward's samples.
    c = MAIN_CFG
    samples = torch.as_tensor(one["latency"]["contour_samples"], device="cuda")
    part = SampleShard(None, 0, 2).take(samples, -3).reshape(-1, c["k"], 2)
    out["k3"] = k3_reading(contour_spline(part, n=1024).contiguous(), c["size"],
                           "one rank's share of a view")
    # K2 at rank 0's rows of the view: the heatmaps of the tail's first
    # block (its first T_e / 2 epistemic samples), 210 of 420.
    task, model, data = setup
    img = torch.as_tensor(next(iter(data.predict_views("test")))["img"], device="cuda")
    with torch.inference_mode():
        logits = forward_views(model, img, c["t_e"],
                               view_generator(c["seed"], 0), SampleShard(None, 0, 2))["out"]
    out["k2"] = k2_reading(logits.reshape(-1, c["size"] ** 2), c["size"])
    out["empty"] = empty_shares_check(setup)
    return out


# [18]: the figures and the prediction writer on [5]'s served views. The
# processors that draw, with calibration and the writer; the five that draw
# record a missing matplotlib under `figure_errors`, the writer a missing
# h5py under `processor_errors`.
FIGURE_PROCESSORS = ["point_metrics", "instant_metrics", "clinical_metrics", "skewness",
                     "plotting"]
FIGURE_RUN = ["point_metrics", "instant_metrics", "calibration", "clinical_metrics",
              "skewness", "plotting", "prediction_writer"]
FIGURE_NPY = ["data_point.npy", "data_instant.npy", "skewness.npy"]
# The dashboards' dense splines (an f64 solve rounded to f32), card against
# CPU on every sample: the bar of tests/test_torch_port_raster.py.
SPLINE_BAR_PX = 2e-4


def same_leaves(got, ref, path: str = "") -> list:
    """The paths where two nested dicts of arrays, lists and scalars
    differ, NaN matching NaN."""
    if isinstance(ref, dict):
        if set(got) != set(ref):
            return [f"{path}: keys {sorted(set(got) ^ set(ref))}"]
        return [p for k in ref for p in same_leaves(got[k], ref[k], f"{path}/{k}")]
    if ref is None or isinstance(ref, (str, bool)):
        return [] if got == ref else [path]
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return [f"{path}: {got.dtype}{got.shape} != {ref.dtype}{ref.shape}"]
    equal = np.array_equal(got, ref, equal_nan=got.dtype.kind in "fc")
    return [] if equal else [path]


def spline_reading(res, card: dict, host: dict) -> dict:
    """Pops the dense splines of both payloads and holds the card's to the
    CPU's: finite, the same shape, within SPLINE_BAR_PX on every sample.
    Also reports the card's distance from an f64 evaluation on the CPU."""
    import torch

    from contouring_uncertainty_torch.ops.spline import contour_spline

    inst = res.instants or {"ED": 0, "ES": min(1, res.img.shape[0] - 1)}
    diffs, errs = [], []
    for name in ("ED", "ES"):
        g = card["panels"][name].pop("dense_samples")
        h = host["panels"][name].pop("dense_samples")
        samples = res.contour_samples[inst[name]][:2, :5].reshape(-1, *res.contour_samples.shape[-2:])
        f64 = contour_spline(torch.as_tensor(samples, dtype=torch.float64), n=256).numpy()
        if g.shape != h.shape or g.shape != f64.shape or not np.isfinite(g).all():
            raise AssertionError(f"view {res.id} {name}: dense splines {g.shape} on the card "
                                 f"(finite: {np.isfinite(g).all()}), {h.shape} on the CPU")
        diff = np.abs(g - h).max(axis=(1, 2))
        if not (diff <= SPLINE_BAR_PX).all():
            raise AssertionError(f"view {res.id} {name}: dense splines card vs CPU {diff} px "
                                 f"(bar {SPLINE_BAR_PX})")
        diffs.append(diff)
        errs.append(np.abs(g - f64).max(axis=(1, 2)))
    diffs, errs = np.concatenate(diffs), np.concatenate(errs)
    return {"shape": g.shape, "max": float(diffs.max()), "samples": len(diffs),
            "max_f64": float(errs.max())}


def figure_phase(main_res: dict) -> dict:
    """[18]: the processors that draw and the writer on [5]'s served views,
    on the card and on the CPU, their outcome asserted by what this machine
    has (matplotlib, h5py); the dashboards' payloads on the card against
    the CPU from the CPU run's rows and MC populations; val_figure once."""
    import importlib.util
    import tempfile

    import torch

    from contouring_uncertainty_torch.ops import dsnt_kernel, select_kernel
    from contouring_uncertainty_torch.results import clinical, metric_figures, run_processors

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    has_h5py = importlib.util.find_spec("h5py") is not None
    results = main_res["results"]
    cfg = {"data": {"results_processors": FIGURE_RUN}}

    def counts():
        return (dsnt_kernel.row_launches, dsnt_kernel.col_launches, select_kernel.launches)

    calls = []
    out = {"matplotlib": has_mpl, "h5py": has_h5py, "views": len(results)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu = run_processors(results, tmp / "gpu", cfg, device="cuda")
        torch.cuda.synchronize()
        out["host_ms_per_view"] = (time.perf_counter() - t0) * 1e3 / len(results)
        out["processor_launches"] = tuple(a - b for a, b in zip(counts(), before))
        with recording(clinical, "view_dashboards", calls.append):
            cpu = run_processors(results, tmp / "cpu", cfg, device="cpu")
        for side, metrics, root in (("card", gpu, tmp / "gpu"), ("CPU", cpu, tmp / "cpu")):
            pngs = sorted(str(p.relative_to(root)) for p in root.rglob("*.png"))
            errors = metrics.get("processor_errors", {})
            if has_h5py:
                if errors:
                    raise AssertionError(f"processor errors on the {side}: {errors}")
                import h5py

                with h5py.File(root / "predictions.h5", "r") as f:
                    groups = sorted(f"{a}/{b}" for a in f for b in f[a])
                if groups != sorted(r.id for r in results):
                    raise AssertionError(f"predictions.h5 on the {side} holds {groups}")
            else:
                want = {"prediction_writer": "ModuleNotFoundError: No module named 'h5py'"}
                if errors != want or (root / "predictions.h5").exists():
                    raise AssertionError(f"without h5py, the {side}'s processor errors are "
                                         f"{errors} (want {want}) and predictions.h5 "
                                         f"{'was' if (root / 'predictions.h5').exists() else 'was not'} written")
            fig_errors = metrics.get("figure_errors")
            dash_error = metrics.get("clinical_metrics/metric_figures_error", "")
            if has_mpl:
                if fig_errors or dash_error or not pngs:
                    raise AssertionError(f"with matplotlib, the {side} gave figure errors "
                                         f"{fig_errors}, {dash_error!r} and {len(pngs)} PNGs")
            else:
                want = {name: "ModuleNotFoundError: No module named 'matplotlib'"
                        for name in FIGURE_PROCESSORS}
                if fig_errors != want or "matplotlib" not in dash_error or pngs:
                    raise AssertionError(f"without matplotlib, the {side} gave figure errors "
                                         f"{fig_errors}, metric_figures_error {dash_error!r} "
                                         f"and PNGs {pngs[:5]}")
            out[f"{side}_pngs"] = pngs
        if out["card_pngs"] != out["CPU_pngs"]:
            raise AssertionError("the card's figures differ from the CPU's: "
                                 f"{sorted(set(out['card_pngs']) ^ set(out['CPU_pngs']))}")
        if set(gpu) != set(cpu):
            raise AssertionError(f"summary keys differ: {sorted(set(gpu) ^ set(cpu))}")
        bad = {k: (gpu[k], cpu[k]) for k in cpu if differing(k, gpu[k], cpu[k])}
        csvs = sorted(str(p.relative_to(tmp / "cpu")) for p in (tmp / "cpu").rglob("*.csv"))
        for name in csvs:
            header, rows = read_csv_cells(tmp / "gpu" / name)
            ref_header, ref_rows = read_csv_cells(tmp / "cpu" / name)
            if header != ref_header or [r[0] for r in rows] != [r[0] for r in ref_rows]:
                raise AssertionError(f"{name}: the card's columns or rows differ from the CPU's")
            for row, ref_row in zip(rows, ref_rows):
                for col, got, ref in zip(header[1:], row[1:], ref_row[1:]):
                    if differing(col, got, ref):
                        bad[f"{name}:{row[0]}:{col}"] = (got, ref)
        for name in FIGURE_NPY:
            diff = same_leaves(np.load(tmp / "gpu" / name, allow_pickle=True).item(),
                               np.load(tmp / "cpu" / name, allow_pickle=True).item())
            if diff:
                bad[name] = diff[:5]
        if bad:
            raise AssertionError(f"the card's processor outputs differ from the CPU's "
                                 f"(tolerance {PROCESSOR_TOL}): {dict(list(bad.items())[:10])}")
        out["csvs"], out["npys"] = csvs, FIGURE_NPY
        out["figure_errors"] = gpu.get("figure_errors")
        out["processor_errors"] = gpu.get("processor_errors")
        out["metric_figures_error"] = gpu.get("clinical_metrics/metric_figures_error")

    # The payloads of the CPU run's dashboards, prepared on the card and on
    # the CPU from the same views, rows and MC populations (the processor
    # prepares none where matplotlib is absent).
    if len(calls) != 1 or len(calls[0][0]) != len(results):
        raise AssertionError(f"the CPU run's dashboards were called {len(calls)} times "
                             f"for {len(results)} views")
    fig_payload, instant_rows, view_rows = calls[0][:3]
    payload_ms, splines = [], []
    for res, mc in fig_payload.values():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = metric_figures.prepare_view_payload(res, instant_rows, view_rows, mc, "cuda")
        torch.cuda.synchronize()
        payload_ms.append((time.perf_counter() - t0) * 1e3)
        host = metric_figures.prepare_view_payload(res, instant_rows, view_rows, mc, "cpu")
        splines.append(spline_reading(res, card, host))
        diff = same_leaves(card, host)
        if diff:
            raise AssertionError(f"view {res.id}: the card's payload differs from the CPU's "
                                 f"at {diff[:5]}")
    out["payload_ms"] = payload_ms
    out["splines"] = {"shape": splines[0]["shape"], "samples": sum(r["samples"] for r in splines),
                      **{k: max(r[k] for r in splines) for k in ("max", "max_f64")}}

    # val_figure: matplotlib first, so without it no forward runs.
    task, model = main_res["task"], main_res["model"]
    imgs = np.concatenate([r.img for r in results[:2]])[:4]
    batch = {"img": torch.as_tensor(imgs, dtype=torch.float32, device="cuda"),
             "contour": torch.as_tensor(np.concatenate([r.contour for r in results[:2]])[:4],
                                        device="cuda")}
    before = counts()
    if has_mpl:
        fig = task.val_figure(model, batch)
        if fig is None or len(fig.axes) != 4:
            raise AssertionError(f"val_figure returned {fig}")
        import matplotlib.pyplot as plt

        plt.close(fig)
    else:
        try:
            task.val_figure(model, batch)
        except ModuleNotFoundError as exc:
            if exc.name != "matplotlib":
                raise
        else:
            raise AssertionError("val_figure ran without matplotlib")
    out["val_figure_launches"] = tuple(a - b for a, b in zip(counts(), before))
    if out["val_figure_launches"][0] != (1 if has_mpl else 0):
        raise AssertionError(f"val_figure launched K2 {out['val_figure_launches'][0]} times "
                             f"({'with' if has_mpl else 'without'} matplotlib)")
    return out


def live_children() -> list:
    """This process's child processes that have not been reaped (from
    /proc): every process the run started (the ranks of [17], nvcc,
    nvidia-smi) must have exited by its end."""
    me = str(os.getpid())
    left = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            text = stat.read_text()
        except OSError:  # exited while listed
            continue
        name, rest = text.split("(", 1)[1].rsplit(")", 1)
        state, ppid = rest.split()[:2]
        if ppid == me:
            left.append(f"pid {stat.parent.name} {name} (state {state})")
    return left


def epilogue_errors(got, ref, dx_ref) -> dict:
    """Errors of (y, dx, d conv_bias, d weight, d bias) against an f64
    reference: each the largest |difference| over the largest |reference|;
    the conv bias's gradient, a sum of dx that cancels to rounding, over
    the largest per-channel sum of |dx|."""
    names = ("y", "dx", "d conv_bias", "d weight", "d bias")
    out = {}
    for name, g, r in zip(names, got, ref):
        diff = float((g.double() - r).abs().max())
        scale = (float(dx_ref.abs().sum(dim=(0, 2, 3)).max()) if name == "d conv_bias"
                 else float(r.abs().max()))
        out[name] = diff / scale
    return out


def epilogue_block(channels: int, side: int, drop: bool, seed: int) -> dict:
    """One ConvBlock's plane shape at EPILOGUE_BATCH: the kernels and the
    plain f32 chain against f64, and their times."""
    import torch
    import torch.nn.functional as F

    from contouring_uncertainty_torch.models.layers import InstanceNorm, channel_keep
    from contouring_uncertainty_torch.ops import conv_epilogue as ce

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (EPILOGUE_BATCH, channels, side, side)
    randn = lambda *size: torch.randn(*size, generator=gen, device="cuda")
    x = 0.4 + 1.3 * randn(*shape)
    cb, w, b = 0.2 * randn(channels), 1.0 + 0.3 * randn(channels), 0.5 * randn(channels)
    gy = randn(*shape)
    keep = channel_keep(x, 0.5, gen) if drop else None
    kp = 0.5 if drop else 1.0

    norm = InstanceNorm(channels).cuda()
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)

    xl, cbl = x.detach().requires_grad_(), cb.detach().requires_grad_()

    def plain_forward():
        v = xl + cbl[:, None, None]
        if drop:
            v = torch.where(keep[:, :, None, None], v / kp, torch.zeros((), device="cuda"))
        return F.leaky_relu(norm(v), 0.01), [xl, cbl, norm.weight, norm.bias]

    def plain_step():
        y_p, leaves = plain_forward()
        return torch.autograd.grad(y_p, leaves, gy)

    y, stats = ce.epilogue_cuda(x, cb, keep, kp, w, b)
    dx, dcb, dw, db = ce.epilogue_backward_cuda(x, cb, keep, kp, w, b, stats, gy)
    y_p, leaves = plain_forward()
    g_p = torch.autograd.grad(y_p, leaves, gy)
    y_p = y_p.detach()
    x64, cb64, w64, b64, gy64 = (t.double() for t in (x, cb, w, b, gy))
    y64, st64 = ce.epilogue_plain(x64, cb64, keep, kp, w64, b64)
    refs = {}
    for label, ys in (("kernel", y), ("plain", y_p)):
        grads = ce.epilogue_backward_plain(x64, cb64, keep, kp, w64, b64, st64, gy64,
                                           sides=ys > 0)
        refs[label] = (y64, grads[0], grads[1], grads[2], grads[3])
    err = {"kernel": epilogue_errors((y, dx, dcb, dw, db), refs["kernel"], refs["kernel"][1]),
           "plain": epilogue_errors((y_p, g_p[0], g_p[1], g_p[2], g_p[3]), refs["plain"],
                                    refs["plain"][1])}
    flips = int(((y > 0) != (y64 > 0)).sum())
    del y64, st64, refs, x64, gy64
    share = {k: err["kernel"][k] / max(err["plain"][k], EPILOGUE_FLOOR) for k in err["kernel"]}
    elems = x.numel()
    row = {
        "shape": list(shape), "dropout": drop, "errors": err, "of_plain": share, "flips": flips,
        "fwd_ms": cuda_ms(lambda: ce.epilogue_cuda(x, cb, keep, kp, w, b)),
        "bwd_ms": cuda_ms(lambda: ce.epilogue_backward_cuda(x, cb, keep, kp, w, b, stats, gy)),
        "fwd_bound_ms": 8.0 * elems / HBM_BYTES_PER_S * 1e3,
        "bwd_bound_ms": 12.0 * elems / HBM_BYTES_PER_S * 1e3,
        "plain_fwd_ms": cuda_ms(lambda: plain_forward()[0]),
        "plain_step_ms": cuda_ms(plain_step),
    }
    row["plain_bwd_ms"] = row["plain_step_ms"] - row["plain_fwd_ms"]
    if max(share.values()) > EPILOGUE_BAR:
        raise AssertionError(f"conv epilogue kernels at {shape} (dropout {drop}): errors {err} "
                             f"exceed {EPILOGUE_BAR}x the plain chain's: {share}")
    return row


def epilogue_phase() -> dict:
    """[19]: every block of EPILOGUE_BLOCKS (epilogue_block) and the step's
    30 layers summed."""
    import torch

    rows = []
    for i, (channels, side, drop) in enumerate(EPILOGUE_BLOCKS):
        row = epilogue_block(channels, side, drop, seed=100 + i)
        rows.append(row)
        e, r = row["errors"], row["of_plain"]
        print(f"    {tuple(row['shape'])}{' dropout' if drop else ''}: forward "
              f"{row['fwd_ms']:.4f} ms (bound {row['fwd_bound_ms']:.4f}, "
              f"{row['fwd_bound_ms'] / row['fwd_ms']:.0%}), backward {row['bwd_ms']:.4f} ms "
              f"(bound {row['bwd_bound_ms']:.4f}, {row['bwd_bound_ms'] / row['bwd_ms']:.0%}); "
              f"plain chain {row['plain_fwd_ms']:.4f} + {row['plain_bwd_ms']:.4f} ms")
        print("      error vs f64, kernel [plain]: " + ", ".join(
            f"{k} {e['kernel'][k]:.2e} [{e['plain'][k]:.2e}]" for k in e["kernel"])
            + f"; worst share {max(r.values()):.2f} of the plain chain's "
              f"(bar {EPILOGUE_BAR}); kernel kinks on the other side from f64: {row['flips']}")
        torch.cuda.empty_cache()
    step = {k: 2 * sum(row[k] for row in rows)
            for k in ("fwd_ms", "bwd_ms", "fwd_bound_ms", "bwd_bound_ms", "plain_fwd_ms",
                      "plain_bwd_ms")}
    print(f"    a step's 30 ConvLayers at batch {EPILOGUE_BATCH}: kernels "
          f"{step['fwd_ms']:.3f} + {step['bwd_ms']:.3f} ms (bound {step['fwd_bound_ms']:.3f} + "
          f"{step['bwd_bound_ms']:.3f} ms, "
          f"{(step['fwd_bound_ms'] + step['bwd_bound_ms']) / (step['fwd_ms'] + step['bwd_ms']):.0%}"
          f"), plain chain {step['plain_fwd_ms']:.3f} + {step['plain_bwd_ms']:.3f} ms")
    return {"blocks": rows, "step": step}


def epilogue_kernel_entry(epilogue: dict, paths: dict) -> dict:
    """The kernels line's entry of the ConvLayer epilogue kernels: each
    training path's launches per train step (`paths`, label -> (forward,
    backward)), and [19]'s times, bounds and the plain chain's per shape
    and for a step's 30 layers."""
    keys = ("fwd_ms", "fwd_bound_ms", "bwd_ms", "bwd_bound_ms", "plain_fwd_ms", "plain_bwd_ms")
    return {"name": "conv_epilogue (ConvLayer epilogue, forward and backward)",
            "training_launches_per_step": paths,
            "shapes": [{"shape": row["shape"], "dropout": row["dropout"],
                        **{k: row[k] for k in keys}} for row in epilogue["blocks"]],
            "step": epilogue["step"]}


def norm_chain_block(chain: str, channels: int, side: int, seed: int) -> dict:
    """One DeepLabV3 norm chain at one plane shape at EPILOGUE_BATCH: the
    kernels and the plain f32 chain against f64, and their times."""
    import torch
    import torch.nn.functional as F

    from contouring_uncertainty_torch.models.layers import InstanceNorm, channel_keep
    from contouring_uncertainty_torch.ops import conv_epilogue as ce

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (EPILOGUE_BATCH, channels, side, side)
    randn = lambda *size: torch.randn(*size, generator=gen, device="cuda")
    a = 0.4 + 1.3 * randn(*shape)
    w, b = 1.0 + 0.3 * randn(channels), 0.5 * randn(channels)
    r = 0.7 * randn(*shape) if chain == "T" else None
    gy = randn(*shape)
    keep = channel_keep(a, DEEPLAB_DROPOUT, gen) if chain == "T" else None
    kp = 1.0 - DEEPLAB_DROPOUT
    act = {"A": "relu", "P": None}.get(chain)

    norm = InstanceNorm(channels).cuda()
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    al = a.detach().requires_grad_()
    rl = None if r is None else r.detach().requires_grad_()

    def plain_forward():
        z = norm(al)
        if chain == "T":
            z = torch.where(keep[:, :, None, None], z / kp, torch.zeros((), device="cuda"))
            return F.relu(z + rl), [al, norm.weight, norm.bias, rl]
        return (F.relu(z) if act else z), [al, norm.weight, norm.bias]

    def plain_step():
        y_p, leaves = plain_forward()
        return torch.autograd.grad(y_p, leaves, gy)

    if chain == "T":
        fwd = lambda: ce.tail_cuda(a, keep, kp, w, b, r)
        y, stats = fwd()
        bwd = lambda: ce.tail_backward_cuda(a, keep, kp, w, b, stats, y, gy)
        got = (y, *bwd())
    else:
        fwd = lambda: ce.epilogue_cuda(a, None, None, 1.0, w, b, act)
        y, stats = fwd()
        bwd = lambda: ce.epilogue_backward_cuda(a, None, None, 1.0, w, b, stats, gy,
                                                activation=act)
        dx, _, dw, db = bwd()
        got = (y, dx, dw, db)
    y_p, leaves = plain_forward()
    g_p = torch.autograd.grad(y_p, leaves, gy)
    plain = (y_p.detach(), *g_p)
    del y_p, leaves  # no graph of an eager step outlives it into the captured ones
    a64, w64, b64, gy64 = (t.double() for t in (a, w, b, gy))
    names = ("y", "da", "d weight", "d bias", "dr")
    err = {}
    for label, out in (("kernel", got), ("plain", plain)):
        ys = out[0]
        if chain == "T":
            y64, st64 = ce.tail_plain(a64, keep, kp, w64, b64, r.double())
            da, dw, db, dr = ce.tail_backward_plain(a64, keep, kp, w64, b64, st64, ys.double(),
                                                    gy64)
            ref = (y64, da, dw, db, dr)
        else:
            y64, st64 = ce.epilogue_plain(a64, None, None, 1.0, w64, b64, act)
            dx, _, dw, db = ce.epilogue_backward_plain(a64, None, None, 1.0, w64, b64, st64,
                                                       gy64, sides=ys > 0, activation=act)
            ref = (y64, dx, dw, db)
        # Both outputs in `names` order: y, then a's, the weight's, the bias's
        # (and r's) gradients.
        err[label] = {n: float((g.double() - rf).abs().max()) / max(float(rf.abs().max()), 1e-30)
                      for n, g, rf in zip(names, out, ref)}
        del y64, st64, ref
    share = {k: err["kernel"][k] / max(err["plain"][k], EPILOGUE_FLOOR) for k in err["kernel"]}
    elems = a.numel()
    fwd_bytes, bwd_bytes = CHAIN_BYTES[chain]
    row = {
        "chain": chain, "shape": list(shape), "errors": err, "of_plain": share,
        "fwd_ms": cuda_ms(fwd), "bwd_ms": cuda_ms(bwd),
        "fwd_bound_ms": fwd_bytes * elems / HBM_BYTES_PER_S * 1e3,
        "bwd_bound_ms": bwd_bytes * elems / HBM_BYTES_PER_S * 1e3,
        "plain_fwd_ms": cuda_ms(lambda: plain_forward()[0]),
        "plain_step_ms": cuda_ms(plain_step),
    }
    row["plain_bwd_ms"] = row["plain_step_ms"] - row["plain_fwd_ms"]
    if side == 1:  # ASPP's pooled planes: exactly the norm's bias, through the activation
        want = F.relu(b)[None, :, None, None].expand_as(y) if act else \
            b[None, :, None, None].expand_as(y)
        if not torch.equal(y, want):
            raise AssertionError(f"norm chain {chain} on 1x1 planes: not the norm's bias")
    if max(share.values()) > EPILOGUE_BAR:
        raise AssertionError(f"norm chain {chain} kernels at {shape}: errors {err} exceed "
                             f"{EPILOGUE_BAR}x the plain chain's: {share}")
    return row


def deeplab_step_launches(steps: int = 2) -> dict:
    """A full-width DeepLabV3 (base 64, layers [3, 4, 6, 3], dropout 0.1)
    training forward and backward at EPILOGUE_BATCH x 256^2, `steps` times:
    one forward and one backward kernel per norm in each (44 conv
    epilogue, 16 norm tail), every chain on the kernel route; then its
    output, loss and gradients beside the op-by-op model's on the same
    weights, input and draws (printed, not gated: the portbench cell holds
    the whole step to its reference)."""
    import torch

    from contouring_uncertainty_torch.models import layers
    from contouring_uncertainty_torch.models.deeplabv3 import DeepLabV3
    from contouring_uncertainty_torch.ops import conv_epilogue as ce

    model = DeepLabV3((1, 256, 256), (21, 256, 256), dropout=DEEPLAB_DROPOUT)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.cuda()
    x = torch.randn(EPILOGUE_BATCH, 1, 256, 256, generator=torch.Generator().manual_seed(1))
    x = x.cuda()
    weight = torch.linspace(-1, 1, EPILOGUE_BATCH * 21 * 256 * 256, device="cuda")

    def step():
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(2)
        out = model(x, deterministic=False, generator=gen)["out"]
        loss = (out.reshape(-1) * weight).sum() / weight.numel()
        loss.backward()
        return (out.detach(), float(loss.detach()),
                {n: p.grad.clone() for n, p in model.named_parameters()})

    counts = []
    for _ in range(steps):
        with routed_chains() as routed:
            before = (ce.fwd_launches, ce.bwd_launches, ce.tail_fwd_launches,
                      ce.tail_bwd_launches)
            out, loss, grads = step()
            after = (ce.fwd_launches, ce.bwd_launches, ce.tail_fwd_launches,
                     ce.tail_bwd_launches)
        counts.append((*(q - p for p, q in zip(before, after)), routed[0]))
    if set(counts) != {(44, 44, 16, 16, DEEPLAB_NORMS)}:
        raise AssertionError(f"DeepLabV3 train step: (epilogue forward, backward, tail forward, "
                             f"backward, chains on the kernel route) {counts}, expected "
                             f"(44, 44, 16, 16, {DEEPLAB_NORMS}) in every step")
    route_fn = layers.chain_route
    layers.chain_route = lambda *args: "plain"
    try:
        out_p, loss_p, grads_p = step()
    finally:
        layers.chain_route = route_fn
    leaf = {n: float((grads[n].norm() - grads_p[n].norm()).abs() / grads_p[n].norm().clamp_min(
        1e-30)) for n in grads}
    worst = max(leaf, key=leaf.get)
    row = {"launches_per_step": {"epilogue": [44, 44], "tail": [16, 16]},
           "steps": steps, "out_rel": float((out - out_p).abs().max() / out_p.abs().max()),
           "loss_rel": abs(loss - loss_p) / abs(loss_p), "worst_leaf": [worst, leaf[worst]]}
    if not all(np.isfinite(v) for v in (row["out_rel"], row["loss_rel"], leaf[worst])):
        raise AssertionError(f"DeepLabV3 fused against op by op: not finite: {row}")
    return row


def norm_chain_phase() -> dict:
    """[20]: every chain of DEEPLAB_CHAINS (norm_chain_block), a step's 60
    norms summed, and the launches of a full-width DeepLabV3 train step
    (deeplab_step_launches)."""
    import torch

    rows = []
    for i, (chain, channels, side, count) in enumerate(DEEPLAB_CHAINS):
        row = norm_chain_block(chain, channels, side, seed=200 + i)
        row["count"] = count
        rows.append(row)
        e, r = row["errors"], row["of_plain"]
        print(f"    {chain} {tuple(row['shape'])} x{count}: forward {row['fwd_ms']:.4f} ms (bound "
              f"{row['fwd_bound_ms']:.4f}, {row['fwd_bound_ms'] / row['fwd_ms']:.0%}), backward "
              f"{row['bwd_ms']:.4f} ms (bound {row['bwd_bound_ms']:.4f}, "
              f"{row['bwd_bound_ms'] / row['bwd_ms']:.0%}); plain chain "
              f"{row['plain_fwd_ms']:.4f} + {row['plain_bwd_ms']:.4f} ms")
        print("      error vs f64, kernel [plain]: " + ", ".join(
            f"{k} {e['kernel'][k]:.2e} [{e['plain'][k]:.2e}]" for k in e["kernel"])
            + f"; worst share {max(r.values()):.2f} of the plain chain's (bar {EPILOGUE_BAR})")
        torch.cuda.empty_cache()
    keys = ("fwd_ms", "bwd_ms", "fwd_bound_ms", "bwd_bound_ms", "plain_fwd_ms", "plain_bwd_ms")
    step = {}
    for chain in ("A", "P", "T", None):
        mine = [row for row in rows if chain in (None, row["chain"])]
        step[chain or "all"] = {k: sum(row["count"] * row[k] for row in mine) for k in keys}
    for label, t in step.items():
        print(f"    a step's {label} chains at batch {EPILOGUE_BATCH}: kernels "
              f"{t['fwd_ms']:.3f} + {t['bwd_ms']:.3f} ms (bound {t['fwd_bound_ms']:.3f} + "
              f"{t['bwd_bound_ms']:.3f} ms, "
              f"{(t['fwd_bound_ms'] + t['bwd_bound_ms']) / (t['fwd_ms'] + t['bwd_ms']):.0%}), "
              f"plain chain {t['plain_fwd_ms']:.3f} + {t['plain_bwd_ms']:.3f} ms")
    launches = deeplab_step_launches()
    print(f"    DeepLabV3 train step (batch {EPILOGUE_BATCH}, 256^2, dropout {DEEPLAB_DROPOUT}): "
          f"launches per step {launches['launches_per_step']} ({DEEPLAB_NORMS} norms) over "
          f"{launches['steps']} steps; against the op-by-op model: output "
          f"{launches['out_rel']:.2e}, loss {launches['loss_rel']:.2e}, worst leaf "
          f"{launches['worst_leaf'][0]} {launches['worst_leaf'][1]:.2e}")
    return {"blocks": rows, "step": step, "train_step": launches}


def norm_chain_kernel_entry(chains: dict) -> dict:
    """The kernels line's entry of DeepLabV3's norm chain kernels: [20]'s
    launches per train step, times, bounds and the plain chain's per shape
    and for a step's 60 norms."""
    keys = ("fwd_ms", "fwd_bound_ms", "bwd_ms", "bwd_bound_ms", "plain_fwd_ms", "plain_bwd_ms")
    return {"name": "norm chains (DeepLabV3: conv epilogue with ReLU or none, norm tail)",
            "training_launches_per_step": chains["train_step"]["launches_per_step"],
            "shapes": [{"chain": row["chain"], "shape": row["shape"], "count": row["count"],
                        **{k: row[k] for k in keys}} for row in chains["blocks"]],
            "step": chains["step"]}


def wgrad_block(co: int, ci: int, side: int, stride: int, seed: int) -> dict:
    """One 1x1 shape at WGRAD_BATCH: the kernel twice (the same bits) and
    the plain f32 version against f64; the kernel, the plain version,
    cuDNN's weight gradient (heuristics and benchmark mode), cuDNN's data
    gradient alone and torch.matmul's batched product and sum, timed."""
    import torch

    from contouring_uncertainty_torch.ops import conv1x1_wgrad as cw

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(WGRAD_BATCH, ci, side, side, generator=gen, device="cuda")
    ho = (side - 1) // stride + 1
    gy = torch.randn(WGRAD_BATCH, co, ho, ho, generator=gen, device="cuda")
    w = torch.randn(co, ci, 1, 1, generator=gen, device="cuda")
    xs = cw.strided_input(x, (stride, stride))
    got = cw.wgrad_cuda(gy, xs)
    if not torch.equal(got, cw.wgrad_cuda(gy, xs)):
        raise AssertionError(f"1x1 weight gradient {(co, ci, side, stride)}: two launches differ")
    ref = cw.wgrad_plain(gy.double(), xs.double())
    rel = lambda t: float((t.double() - ref).norm() / ref.norm().clamp_min(1e-300))
    err = {"kernel": rel(got), "plain": rel(cw.wgrad_plain(gy, xs))}
    if max(err.values()) > WGRAD_BAR:
        raise AssertionError(f"1x1 weight gradient {(co, ci, side, stride)}: errors against "
                             f"f64 {err} exceed {WGRAD_BAR}")
    conv_backward = lambda mask: torch.ops.aten.convolution_backward(
        gy, x, w, None, [stride, stride], [0, 0], [1, 1], False, [0, 0], 1, mask)
    np_ = WGRAD_BATCH * ho * ho
    row = {"shape": [co, ci, side, stride], "plan": list(cw.wgrad_plan(co, ci, np_, n_sm())),
           "errors": err, "kernel_ms": cuda_ms(lambda: cw.wgrad_cuda(gy, xs)),
           "bound_ms": cw.bound_seconds(co, ci, np_) * 1e3,
           "bound_by": "operations" if 2 * co * ci * np_ / F32_OPS_PER_S
           >= 4 * (co + ci) * np_ / HBM_BYTES_PER_S else "bytes",
           "plain_ms": cuda_ms(lambda: cw.wgrad_plain(gy, xs)),
           "cudnn_wgrad_ms": cuda_ms(lambda: conv_backward([False, True, False])),
           "cudnn_dgrad_ms": cuda_ms(lambda: conv_backward([True, False, False])),
           "matmul_ms": cuda_ms(lambda: torch.matmul(
               gy.reshape(WGRAD_BATCH, co, -1),
               xs.reshape(WGRAD_BATCH, ci, -1).transpose(1, 2)).sum(0))}
    torch.backends.cudnn.benchmark = True
    try:
        row["cudnn_benchmark_wgrad_ms"] = cuda_ms(lambda: conv_backward([False, True, False]))
    finally:
        torch.backends.cudnn.benchmark = False
    row["share"] = row["bound_ms"] / row["kernel_ms"]
    return row


def wgrad_step_launches() -> dict:
    """The kernel's launches (the reduce pass's apart) in one training
    forward and backward at WGRAD_BATCH x 256^2 where no train step of the
    other phases shows them: a bf16 DeepLabV3, an f64 one (batch 2, 64^2)
    and a no_grad forward of the f32 one: none. Then the cuDNN forward and
    data gradient kernels of the f32 DeepLabV3 step against the same step
    with the route off (`wgrad_route` -> "plain"): the same names; and the
    cuDNN weight gradient kernels' launches and time in both."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from contouring_uncertainty_torch.models import layers
    from contouring_uncertainty_torch.models.deeplabv3 import DeepLabV3

    def model_of(dtype=torch.float32):
        model = DeepLabV3((1, 256, 256), (21, 256, 256), dropout=DEEPLAB_DROPOUT, dtype=dtype)
        model.reset_parameters(torch.Generator().manual_seed(0))
        return model.to("cuda", torch.float64 if dtype == torch.float64 else torch.float32)

    def step(model, batch=WGRAD_BATCH, size=256, grad=True):
        x = torch.randn(batch, 1, size, size, device="cuda",
                        dtype=next(model.parameters()).dtype)
        before = wgrad_launches()
        with torch.set_grad_enabled(grad):
            out = model(x, deterministic=False,
                        generator=torch.Generator(device="cuda").manual_seed(1))["out"]
            if grad:
                out.float().square().mean().backward()
        torch.cuda.synchronize()
        after = wgrad_launches()
        return after[0] - before[0], after[1] - before[1]

    deeplab = model_of()
    counts = {"deeplabv3 bf16": step(model_of(torch.bfloat16)),
              "deeplabv3 f64": step(layers.set_compute_dtype(
                  model_of(torch.float64), torch.float64), batch=2, size=64),
              "deeplabv3 no_grad": step(deeplab, grad=False)}
    if set(counts.values()) != {(0, 0)}:
        raise AssertionError(f"1x1 weight gradient launches (kernel, reduce) {counts}, "
                             f"expected none")

    def cudnn_kernels():
        """The step's cuDNN forward and data gradient kernel names, and its
        weight gradient kernels' (launches, ms) (the port's kernel apart)."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(deeplab)
        events = prof.key_averages()
        names = {e.key for e in events if "fprop" in e.key or "dgrad" in e.key}
        wgrad = [e for e in events if "wgrad" in e.key and "conv1x1_wgrad" not in e.key]
        return names, (sum(e.count for e in wgrad),
                       sum(e.device_time_total for e in wgrad) / 1e3)

    routed, routed_wgrad = cudnn_kernels()
    route_fn = layers.wgrad_route
    layers.wgrad_route = lambda *args: "plain"
    try:
        plain, plain_wgrad = cudnn_kernels()
    finally:
        layers.wgrad_route = route_fn
    if routed != plain:
        raise AssertionError(f"DeepLabV3 step: cuDNN forward and data gradient kernels differ "
                             f"with the route ({sorted(routed - plain)}) and without it "
                             f"({sorted(plain - routed)})")
    return {"per_step": counts, "cudnn_fprop_dgrad": sorted(routed),
            "cudnn_wgrad": {"route": routed_wgrad, "plain": plain_wgrad}}


def wgrad_phase() -> dict:
    """[21]: every shape of WGRAD_1X1 (wgrad_block), a step's 1x1s summed
    per model, and the launches where no train step shows them
    (wgrad_step_launches)."""
    import torch

    rows = []
    for i, (model, co, ci, side, stride, count) in enumerate(WGRAD_1X1):
        row = wgrad_block(co, ci, side, stride, seed=300 + i)
        row.update(model=model, count=count)
        rows.append(row)
        e = row["errors"]
        print(f"    {model} {co}x{ci} at {side}^2 stride {stride} x{count}: kernel "
              f"{row['kernel_ms']:.4f} ms (bound {row['bound_ms']:.4f} by {row['bound_by']}, "
              f"{row['share']:.0%}; plan {row['plan']}), plain {row['plain_ms']:.4f}; cuDNN "
              f"wgrad {row['cudnn_wgrad_ms']:.4f} (benchmark mode "
              f"{row['cudnn_benchmark_wgrad_ms']:.4f}), dgrad {row['cudnn_dgrad_ms']:.4f}; "
              f"matmul and sum {row['matmul_ms']:.4f}; error vs f64 kernel {e['kernel']:.2e} "
              f"[plain {e['plain']:.2e}] (bar {WGRAD_BAR})")
        torch.cuda.empty_cache()
    keys = ("kernel_ms", "bound_ms", "plain_ms", "cudnn_wgrad_ms", "cudnn_benchmark_wgrad_ms",
            "cudnn_dgrad_ms", "matmul_ms")
    step = {m: {k: sum(r["count"] * r[k] for r in rows if r["model"] == m) for k in keys}
            for m in ("deeplabv3", "unet2")}
    for model, t in step.items():
        print(f"    a {model} step's 1x1 weight gradients at batch {WGRAD_BATCH}: kernel "
              f"{t['kernel_ms']:.3f} ms (bound {t['bound_ms']:.3f}, "
              f"{t['bound_ms'] / t['kernel_ms']:.0%}); cuDNN wgrad {t['cudnn_wgrad_ms']:.3f} "
              f"(benchmark mode {t['cudnn_benchmark_wgrad_ms']:.3f}), its dgrad "
              f"{t['cudnn_dgrad_ms']:.3f}; matmul and sum {t['matmul_ms']:.3f}")
    launches = wgrad_step_launches()
    print(f"    launches (kernel, reduce) in a step: {launches['per_step']}; cuDNN forward "
          f"and data gradient kernels the same with and without the route "
          f"({len(launches['cudnn_fprop_dgrad'])} names); cuDNN's weight gradient kernels in "
          f"the f32 DeepLabV3 step (launches, ms): {launches['cudnn_wgrad']['route']} with the "
          f"route, {launches['cudnn_wgrad']['plain']} without it")
    return {"blocks": rows, "step": step, "train_step": launches}


def wgrad_kernel_entry(wgrad: dict, paths: dict) -> dict:
    """The kernels line's entry of the 1x1 weight gradient kernel: its
    launches a train step on each training path (`paths`, from
    `epilogue_ledger`) and in [21]'s bf16, f64 and no_grad steps, and
    times, bounds and yardsticks per shape and per step."""
    keys = ("kernel_ms", "bound_ms", "bound_by", "plain_ms", "cudnn_wgrad_ms",
            "cudnn_benchmark_wgrad_ms", "cudnn_dgrad_ms", "matmul_ms")
    return {"name": "1x1 convolution weight gradient (split-K, csrc/conv1x1_wgrad.cu)",
            "training_launches_per_step": {
                **paths, **{k: v[0] for k, v in wgrad["train_step"]["per_step"].items()}},
            "shapes": [{"model": r["model"], "shape": r["shape"], "count": r["count"],
                        **{k: r[k] for k in keys}} for r in wgrad["blocks"]],
            "step": wgrad["step"]}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; one CUDA GPU is required",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_start = {1: t_start}  # phase -> its start on the host clock
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
    if None in libs:
        raise AssertionError(f"g++ could not build the prefetch library: "
                             f"{build.BUILD_LOGS.get('prefetch_loader')}")
    print(f"[2] build: nvcc and g++ in parallel {time.perf_counter() - t0:.1f} s "
          f"({', '.join(p.name for p in libs)})")
    for name, log in build.BUILD_LOGS.items():
        print("    " + "\n    ".join(line for line in log.splitlines() if "ptxas info" in line
                                    and ("registers" in line or "spill" in line)))

    phase_start[3] = time.perf_counter()
    print("[3] DSNT moment kernels vs plain f64 (420 heatmaps of 256^2, then of 64^2)")
    worst = [check_dsnt(256), check_dsnt(64)]
    dsnt_worst = {k: max(w[k] for w in worst) for k in worst[0]}

    phase_start[4] = time.perf_counter()
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
    phase_start[5] = time.perf_counter()
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

    phase_start[6] = time.perf_counter()
    print("[6] crossing selection vs plain: one view's sampled contours")
    samples = torch.as_tensor(main_res["results"][0].contour_samples, device="cuda")
    check_selection(contour_spline(samples.reshape(-1, MAIN_CFG["k"], 2), n=1024)
                    .contiguous(), 256, 256, "PSM samples")

    phase_start[7] = time.perf_counter()
    print("[7] reference check on a small input")
    small_reference_check()
    clinical_mask_check()

    phase_start[8] = time.perf_counter()
    print("[8] kernel timings at the main path's shapes")
    kernels = kernel_timings(main_res)
    for kern in kernels:
        print(f"    {kern['name'].split(' (')[0]}: {kern['ms']:.4f} ms (bound "
              f"{kern['bound_ms']:.4f} ms by {kern['bound_by']}), plain "
              f"{kern['plain_ms']:.4f} ms, library {kern['library_ms']}, "
              f"launches {kern['launches']} in {main_res['views']} views")
    print(f"    DSNT worst over the parity inputs: {dsnt_worst}")

    phase_start[9] = time.perf_counter()
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
          f"{train['ledger']}; totals {train['totals']}; conv epilogue per train step, every "
          f"step: {train['epilogue']}")
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

    phase_start[10] = time.perf_counter()
    print("[10] skew path: DSNTSkew served (flagship serving width, ConfidenceNet f32) and "
          "trained (flagship training width) through K2 and K3")
    skew = skew_serving(profile_dir)
    lo, hi = skew["ms_range"]
    busy = (skew["kernel_ms_per_view"] + skew["copy_ms_per_view"]) / skew["ms_per_view"]
    print(f"    esn: {skew['views']} views, first run {skew['first_s']:.2f} s; launches "
          f"{skew['launches']} ({SKEW_PER_CALL['predict view']} (K2, K1, K3) per view); steady "
          f"state {skew['views_per_s']:.2f} views/s, median {skew['ms_per_view']:.1f} ms/view over "
          f"{SKEW_PASSES} passes (range {lo:.1f}-{hi:.1f}); device busy {busy:.1%} (kernels "
          f"{skew['kernel_ms_per_view']:.2f} + copies {skew['copy_ms_per_view']:.2f} ms/view), "
          f"idle share {1 - busy:.1%} on {card}")
    print(skew["profile"])
    print(f"    grid (window 64): one view in {skew['grid_ms']:.1f} ms (after a warm-up call)")
    skew_proc = skew_processor_check(skew["results"])
    print(f"    skewness processor, card entry point equal to the CPU's: "
          f"{ {k: round(v, 6) for k, v in skew_proc.items()} }")
    skew_k = skew_kernel_checks(skew)
    print(f"    K3 on one view's {skew_k['level_contours']} level contours: "
          f"{skew_k['k3_ms']:.4f} ms (bound {skew_k['k3_bound_ms']:.4f} ms by "
          f"{skew_k['k3_bound_by']}), plain {skew_k['k3_plain_ms']:.4f} ms, torch.topk "
          f"{skew_k['k3_library_ms']:.4f} ms; {skew_k['narrow_levels']} levels under 5% of the "
          f"widest's area, smallest {skew_k['min_area_px']} px")
    skew_ref = skew_reference_check()
    skew_train = skew_training()
    for row in skew_train["history"]:
        print("    skew epoch {epoch}: train/loss {train/loss:.4f} (term3 {train/loss_term3:.4f}, "
              "alpha_norm {train/alpha_norm:.4f}), val/loss {val/loss:.4f}, val/dice "
              "{val/dice:.4f}".format(**row))
    lo, hi = skew_train["step_ms_range"]
    print(f"    skew train step: median {skew_train['step_ms']:.1f} ms after the first epoch "
          f"(range {lo:.1f}-{hi:.1f}; first {skew_train['first_step_ms']:.1f}), "
          f"{skew_train['images_per_s']:.1f} images/s; val batch median {skew_train['eval_ms']} "
          f"ms; peak {skew_train['peak_gib']:.2f} GiB; run {skew_train['wall_s']:.1f} s; "
          f"launches per call {SKEW_PER_CALL}, calls {skew_train['ledger']}, totals "
          f"{skew_train['totals']} on {card}")
    print(f"    freeze_seg epoch: {skew_train['freeze']['unet_tensors']} backbone tensors "
          f"bitwise unchanged, {skew_train['freeze']['head_tensors']} head tensors moved")

    phase_start[11] = time.perf_counter()
    print("[11] sequence samplers, soft masks and view batching (flagship serving width)")
    seq = sequence_serving(main_res, skew, profile_dir)
    deficient = seq.pop("rank_deficient")
    print(f"    priors fit on {SEQ_PRIOR_PATIENTS} patients' training split "
          f"({seq.pop('data_s'):.1f} s to draw them); the 6 test views of [5]")
    for name, run in seq.items():
        lo, hi = run["ms_range"]
        print(f"    sequence {name}: {run['views']} views, first run {run['first_s']:.2f} s; "
              f"launches {run['launches']} ({SEQ_PER_VIEW[name]} (K2, K1, K3) per view); "
              f"steady state {run['views_per_s']:.2f} views/s, median {run['ms_per_view']:.1f} "
              f"ms/view over {SEQ_PASSES} passes (range {lo:.1f}-{hi:.1f}); kernels "
              f"{run['kernel_ms_per_view']:.2f} + copies {run['copy_ms_per_view']:.2f} ms/view, "
              f"idle share {run['idle_share']:.1%}; the same model without the sequence sampler "
              f"{run['independent_views_per_s']:.2f} views/s in this call, on {card}")
        print(run["profile"])
    print(f"    skew sequence sampler with the sequence prior of [5]'s {deficient['pairs']} "
          f"pairs (rank < 84): {deficient['non_finite']} of {deficient['coordinates']} sampled "
          f"coordinates not finite on one view (the reference's fault, ROADMAP Queue 3)")
    coupling = sequence_coupling()
    for name, row in coupling.items():
        print(f"    sequence {name} on a synthetic (ED, ES) population ({row['pairs']} pairs): "
              f"mean drift from the prediction ED {row['drift_px'][0]:.2f} px, ES "
              f"{row['drift_px'][1]:.2f} px (bar 8); mean area ED {row['area_px'][0]:.1f}, "
              f"ES {row['area_px'][1]:.1f} px^2")
    soft = soft_mask_check(main_res)
    print(f"    soft masks over {soft['views']} views: f32 in [0, 1]; blur of one view's "
          f"{soft['masks']} masks, card vs CPU {soft['blur_err']:.2e} (bar 1e-6); processors "
          f"{PROCESSOR_NAMES}: no processor error, {soft['summary_keys']} summary keys")
    batch = view_batching(main_res, skew, profile_dir)
    for name, row in batch.items():
        print(f"    predict_batch_views={BATCH_VIEWS}, {name}: {row['dispatches']} dispatches, "
              f"launches (K2, K1, K3) per dispatch {row['per_dispatch']}; worst view against "
              f"one view per dispatch {row['worst']} (budgets {BATCH_BUDGETS})")
        for v in (1, BATCH_VIEWS):
            r = row[v]
            lo, hi = r["ms_range"]
            print(f"      V={v}: {r['views_per_s']:.2f} views/s, median {r['ms_per_view']:.1f} "
                  f"ms/view over {2 * BATCH_ROUNDS} passes (range {lo:.1f}-{hi:.1f}); kernels "
                  f"{row['runs'][v]['kernel_ms_per_view']:.2f} + copies "
                  f"{row['runs'][v]['copy_ms_per_view']:.2f} ms/view, idle share "
                  f"{r['idle_share']:.1%}, on {card}")
            print(row["runs"][v]["profile"])
    bk = batched_kernel_checks(main_res, batch)
    print(f"    K2 at {bk['k2']['shape']} {bk['k2']['dtype']}: mu err {bk['k2']['err']['mu_px']:.3e} "
          f"px, sigma rel err {bk['k2']['err']['sigma_rel']:.3e}; {bk['k2']['ms']:.4f} ms "
          f"(bound {bk['k2']['bound_ms']:.4f} ms by {bk['k2']['bound_by']}), plain "
          f"{bk['k2']['plain_ms']:.4f} ms")
    print(f"    K3 at {bk['k3']['shape']}: bitwise; {bk['k3']['ms']:.4f} ms (bound "
          f"{bk['k3']['bound_ms']:.4f} ms by {bk['k3']['bound_by']}), plain "
          f"{bk['k3']['plain_ms']:.4f} ms, torch.topk {bk['k3']['library_ms']:.4f} ms")
    phase_start[12] = time.perf_counter()
    print("[12] segmentation baselines (mcdropout, aleatoric, tta, ssn) and the epistemic task: "
          "served (flagship serving width) and trained (flagship training width)")
    seg = seg_serving(main_res, profile_dir)
    for name, row in seg.items():
        lo, hi = row["ms_range"]
        print(f"    {name}: {row['views']} views, first run {row['first_s']:.2f} s; launches "
              f"{row['launches']}; steady state {row['views_per_s']:.2f} views/s, median "
              f"{row['ms_per_view']:.1f} ms/view over {SEG_PASSES} passes (range "
              f"{lo:.1f}-{hi:.1f}); kernels {row['kernel_ms_per_view']:.2f} + copies "
              f"{row['copy_ms_per_view']:.2f} ms/view, idle share {row['idle_share']:.1%}; "
              f"[5]'s DSNT-AL {main_res['views_per_s']:.2f} views/s, on {card}")
        if "morphology" in row:
            m, proc = row["morphology"], row["processors"]
            print(f"      morphology on one view's {m['masks']} untrained sample masks "
                  f"(foreground {m['foreground']:.1%}): iterations {m['iterations']}, host "
                  f"{m['host_ms']:.2f} ms, device {m['device_ms']:.2f} ms "
                  f"({m['host_ms'] / row['ms_per_view']:.1%} of the view's time)")
            if "draw_ms" in row:
                print(f"      the view's normals drawn on the host and copied: "
                      f"{row['draw_ms']:.2f} ms ({row['draw_ms'] / row['ms_per_view']:.1%} of "
                      f"the view's time)")
            print(f"      processors {SEG_PROCESSORS}: no error, {proc['keys']} summary keys, "
                  f"{proc['cells']} CSV cells, card equal to the CPU within {PROCESSOR_TOL}; "
                  f"{proc['host_ms_per_view']:.1f} ms/view on the card")
        else:
            print(f"      task covariances exactly 0; fused covariance vs the f64 spread of the "
                  f"T_e means: {row['cov_rel_err']:.2e} relative (bar "
                  f"{SEG_BARS['epistemic_cov_rel']})")
        print(row["profile"])
    seg_ref = seg_reference_check()
    print(f"    card vs CPU at 64^2 (4-stage f32, same draws): {seg_ref} (bars {SEG_BARS}); "
          "postprocess_batch bitwise, with an equal-size tie")
    seg_train = seg_training()
    for name, row in seg_train.items():
        lo, hi = row["step_ms_range"]
        print(f"    {name} training (batch {TRAIN_CFG['batch']}, 256^2, f32): median "
              f"{row['step_ms']:.1f} ms/step over {SEG_TRAIN_STEPS} steps (range "
              f"{lo:.1f}-{hi:.1f}), peak {row['peak_gib']:.2f} GiB, losses "
              f"{[round(v, 4) for v in row['losses']]}, launches {row['launches']}; one batch, "
              f"10 steps: {row['fit'][0]:.4f} -> {row['fit'][1]:.4f}; [9]'s DSNT-AL "
              f"{train['step_ms']:.1f} ms/step, on {card}")
    phase_start[13] = time.perf_counter()
    print("[13] JSRT chest X-ray path: DSNT-AL, mcdropout and dsnt-skew5 served (flagship "
          "serving width, K=120 in three structures, one frame), DSNT-AL trained (flagship "
          "training width)")
    shutil.rmtree(JSRT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    jdata = jsrt_data()
    films = {s: len(jdata.train_arrays(s)["id"]) for s in ("train", "val", "test")}
    print(f"    {JSRT_CFG['n_items']} generated {JSRT_CFG['size']}^2 films {films} in "
          f"{time.perf_counter() - t0:.1f} s")
    jsrt = jsrt_serving(jdata, profile_dir)
    for name, row in jsrt.items():
        lo, hi = row["ms_range"]
        print(f"    {name}: {row['views']} views, first run {row['first_s']:.2f} s; launches "
              f"{row['launches']} ({JSRT_PER_VIEW[name]} (K2, K1, K3) per view); steady state "
              f"{row['views_per_s']:.2f} views/s, median {row['ms_per_view']:.1f} ms/view over "
              f"{JSRT_PASSES} passes (range {lo:.1f}-{hi:.1f}); kernels "
              f"{row['kernel_ms_per_view']:.2f} + copies {row['copy_ms_per_view']:.2f} ms/view, "
              f"idle share {row['idle_share']:.1%} (profiled over {JSRT_PROFILE_VIEWS} views); "
              f"[5]'s DSNT-AL {main_res['views_per_s']:.2f} views/s, on {card}; {row['seconds']:.1f} "
              f"s (served and timed {row['serve_s']:.1f}, of which profiled "
              f"{row['profile_s']:.1f})")
        if "non_finite_samples" in row:
            print(f"      non-finite sample coordinates: {row['non_finite_samples']} of "
                  f"{row['sample_coordinates']}")
        if "processors" in row:
            proc = row["processors"]
            print(f"      processors: no error, {proc['keys']} summary keys, "
                  f"{proc['host_ms_per_view']:.1f} ms/view on the card; lung_clinical "
                  f"view_df.csv {proc['rows']} rows, CTR_gt {proc['ctr_gt'][0]:.3f}-"
                  f"{proc['ctr_gt'][1]:.3f}, {proc['cells']} cells, card equal to the CPU "
                  f"(areas within {PROCESSOR_TOL} of the structure's area; "
                  f"{proc['csv_check_s']:.1f} s)")
        print(row["profile"])
    jsrt_reference_check()
    jtrain = jsrt_training(jdata)
    lo, hi = jtrain["step_ms_range"]
    print(f"    DSNT-AL training on JSRT (batch {TRAIN_CFG['batch']}, 256^2, K=120, f32): median "
          f"{jtrain['step_ms']:.1f} ms/step over {JSRT_TRAIN_STEPS} steps (range {lo:.1f}-"
          f"{hi:.1f}), peak {jtrain['peak_gib']:.2f} GiB, losses "
          f"{[round(v, 4) for v in jtrain['losses']]}, launches per step {jtrain['per_step']}; "
          f"validation batch of {jtrain['val_rows']}: launches {jtrain['per_val_batch']}, "
          f"loss {jtrain['val']['loss']:.4f}, dice {jtrain['val']['dice']:.4f}; one batch, 10 "
          f"steps: {jtrain['fit'][0]:.4f} -> {jtrain['fit'][1]:.4f}; [9]'s DSNT-AL "
          f"{train['step_ms']:.1f} ms/step, on {card}")
    jk = jsrt_kernel_checks(jsrt, jtrain.pop("logits"), jdata.contour_groups)
    for key in ("k2_serving", "k2_training"):
        r = jk[key]
        print(f"    K2 at {r['shape']} {r['dtype']}: mu err {r['err']['mu_px']:.3e} px, sigma rel "
              f"err {r['err']['sigma_rel']:.3e}; {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}), plain {r['plain_ms']:.4f} ms")
    r = jk["k3"]
    print(f"    K3 at {r['shape']}: bitwise; {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}), plain {r['plain_ms']:.4f} ms, torch.topk {r['library_ms']:.4f} ms")
    shutil.rmtree(JSRT_DIR, ignore_errors=True)

    phase_start[14] = time.perf_counter()
    print("[14] CAMUS source: data=camus-cont task=dsnt-al served (flagship serving width) on "
          "CamusContourData.from_arrays, LV (K=21) and LV+MYO (K=42), landmarks extracted "
          "from the masks; LV+MYO trained (flagship training width)")
    shutil.rmtree(CAMUS_DIR, ignore_errors=True)
    camus = camus_serving(profile_dir)
    for name, row in camus.items():
        lo, hi = row["ms_range"]
        proc = row["processors"]
        print(f"    {name} (K={row['k']}): {row['views']} views, first run {row['first_s']:.2f} s "
              f"(landmarks extracted in {row['data_s']:.1f} s); launches {row['launches']} "
              f"({CAMUS_PER_VIEW[name]} (K2, K1, K3) per view); steady state "
              f"{row['views_per_s']:.2f} views/s, median {row['ms_per_view']:.1f} ms/view over "
              f"{CAMUS_PASSES} passes (range {lo:.1f}-{hi:.1f}); kernels "
              f"{row['kernel_ms_per_view']:.2f} + copies {row['copy_ms_per_view']:.2f} ms/view, "
              f"idle share {row['idle_share']:.1%}; [5]'s DSNT-AL {main_res['views_per_s']:.2f} "
              f"views/s, on {card}; {row['seconds']:.1f} s")
        print(f"      processors {proc['names']}: no error, {proc['keys']} summary keys, "
              f"{proc['cells']} CSV cells, card equal to the CPU within {PROCESSOR_TOL}; "
              f"{proc['host_ms_per_view']:.1f} ms/view on the card ({proc['seconds']:.1f} s)")
        print(row["profile"])
    camus_ref = camus_reference_check()
    print(f"    LV+MYO card vs CPU at 64^2 (4-stage f32, same draws): mu {camus_ref['mu_px']:.2e} "
          f"px, cov {camus_ref['cov_rel']:.2e} of its scale; {camus_ref['maps']} label maps of "
          f"the same samples bitwise, the LV painted over the MYO ({camus_ref['overlap_px']} "
          f"overlapping px)")
    ctrain = camus_training(camus["LV+MYO"]["data"])
    lo, hi = ctrain["step_ms_range"]
    print(f"    LV+MYO DSNT-AL training (batch {TRAIN_CFG['batch']}, 256^2, K=42, f32): median "
          f"{ctrain['step_ms']:.1f} ms/step over {CAMUS_TRAIN_STEPS} steps (range {lo:.1f}-"
          f"{hi:.1f}), peak {ctrain['peak_gib']:.2f} GiB, losses "
          f"{[round(v, 4) for v in ctrain['losses']]}, launches per step {ctrain['per_step']}; "
          f"val-split batch of {ctrain['val_rows']}: launches {ctrain['per_val_batch']}, dice "
          f"{ctrain['val']['dice']:.4f}; one batch, 8 steps: {ctrain['fit'][0]:.4f} -> "
          f"{ctrain['fit'][1]:.4f}; [9]'s DSNT-AL {train['step_ms']:.1f} ms/step, on {card}")

    phase_start[15] = time.perf_counter()
    print("[15] other backbones (ENet, DeepLabV3, the ResNet regressor, UNet with residual and "
          "attention): DSNT-AL trained and served at their configs' full width; mcdropout on "
          "ENet")
    bb = backbones(camus, profile_dir)
    for name, row in bb.items():
        lo, hi = row["ms_range"]
        line = (f"    {name}: {row['views']} views, first run {row['first_s']:.2f} s; launches "
                f"{row['launches']}; steady state {row['views_per_s']:.2f} views/s, median "
                f"{row['ms_per_view']:.1f} ms/view over {BACKBONE_PASSES} passes (range "
                f"{lo:.1f}-{hi:.1f}); kernels {row['kernel_ms_per_view']:.2f} + copies "
                f"{row['copy_ms_per_view']:.2f} ms/view, idle share {row['idle_share']:.1%}")
        if "train" in row:
            t = row["train"]
            line += (f"; {row['params']} parameters; training median {t['step_ms']:.1f} "
                     f"ms/step over {BACKBONE_TRAIN_STEPS} steps, peak {t['peak_gib']:.2f} GiB, "
                     f"losses {[round(v, 4) for v in t['losses']]}, launches per step "
                     f"{t['per_step']}; 64^2 card vs CPU {row['reference_err']:.2e} (bar "
                     f"{BACKBONE_BAR})")
        print(line + f", on {card}; {row['seconds']:.1f} s")
    ck = camus_kernel_checks(camus, bb)
    for key, r in ck.items():
        what = f"K2 at {r['shape']} {r['dtype']}" if key.startswith("k2") else f"K3 at {r['shape']}"
        err = (f"mu err {r['err']['mu_px']:.3e} px, sigma rel err {r['err']['sigma_rel']:.3e}"
               if key.startswith("k2") else f"bitwise, torch.topk {r['library_ms']:.4f} ms")
        print(f"    {key}: {what}: {err}; {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}), plain {r['plain_ms']:.4f} ms")
    shutil.rmtree(CAMUS_DIR, ignore_errors=True)

    phase_start[16] = time.perf_counter()
    print(f"[16] deep ensembles ({ENSEMBLE_MEMBERS} members of [5]'s model, served through "
          "runner.run's eval-only path; task.train_ensemble=2 at [9]'s configuration), bf16 "
          "training at [9]'s configuration, and the C++ prefetcher")
    parts_s = {}  # [16]'s seconds by part
    t_part = time.perf_counter()
    ens = ensemble_serving(main_res, profile_dir)
    parts_s["ensemble serving"] = time.perf_counter() - t_part
    parts_s.update({f"  of which {k[:-2]}": ens[k] for k in
                    ("setup_s", "runner_s", "load_s", "serve_s", "checks_s", "skew_s")})
    parts_s.update({f"    of serve, {k[:-2]}": ens[k] for k in
                    ("first_s", "profile_s", "batched_s")})
    lo, hi = ens["ms_range"]
    print(f"    {ENSEMBLE_MEMBERS} members initialised and saved in {ens['setup_s']:.1f} s; "
          f"runner.run eval-only {ens['runner_s']:.1f} s (calls {ens['runner_calls']}, "
          f"(K2, K1, K3) (1, 0, 1) each; test on member 0: "
          f"{ {k: round(v, 4) for k, v in ens['test'].items()} }; five processors, no error)")
    print(f"    ensemble served ({ens['run']['views']} views, T_e={ENSEMBLE_MEMBERS}, T_a="
          f"{MAIN_CFG['t_a']}, bf16 head): launches {ens['run']['launches']}; steady state "
          f"{ens['views_per_s']:.2f} views/s, median {ens['ms_per_view']:.1f} ms/view over "
          f"{ENSEMBLE_PASSES} passes (range {lo:.1f}-{hi:.1f}); kernels "
          f"{ens['run']['kernel_ms_per_view']:.2f} + copies {ens['run']['copy_ms_per_view']:.2f} "
          f"ms/view, idle share {ens['idle_share']:.1%}; [5]'s MC dropout "
          f"{main_res['views_per_s']:.2f} views/s ({ens['views_per_s'] / main_res['views_per_s']:.2f}x), "
          f"on {card}")
    print(ens["run"]["profile"])
    print(f"    predict_batch_views={BATCH_VIEWS}: launches per dispatch "
          f"{ens['batched']['per_dispatch']}, {ens['batched']['views_per_s']:.2f} views/s (one "
          f"pass); each member's logits in the ensemble bitwise its own; its moments against "
          f"f64 (bars {DSNT_BARS}) and the ensemble's against its own forward's: "
          f"{ens['member_worst']}; skew ensemble on one view: launches {ens['skew_launches']}")
    for key in ("k2", "k3"):
        r = ens[key]
        err = (f"mu err {r['err']['mu_px']:.3e} px, sigma rel err {r['err']['sigma_rel']:.3e}"
               if key == "k2" else f"bitwise, torch.topk {r['library_ms']:.4f} ms")
        print(f"    {key.upper()} at {r['shape']}{' ' + r['dtype'] if key == 'k2' else ''}: "
              f"{err}; {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}), "
              f"plain {r['plain_ms']:.4f} ms")
    t_part = time.perf_counter()
    ens_train = ensemble_training()
    parts_s["ensemble training"] = time.perf_counter() - t_part
    for row in ens_train["history"]:
        print("    ensemble member 1 epoch {epoch}: train/loss {train/loss:.4f}, val/loss "
              "{val/loss:.4f}".format(**row))
    print(f"    task.train_ensemble=2: member_0.ckpt, member_1.ckpt; {ens_train['views']} views "
          f"predicted at T_e=2 with the five processors, no error; calls {ens_train['calls']} "
          f"((K2, K1, K3) {ens_train['per_call']}); fed by {ens_train['feed']}; members' train "
          f"step median {ens_train['step_ms']:.1f} ms (range {ens_train['step_ms_range'][0]:.1f}-"
          f"{ens_train['step_ms_range'][1]:.1f}; [9]'s {train['step_ms']:.1f}); peak "
          f"{ens_train['peak_gib']:.2f} GiB; {ens_train['wall_s']:.1f} s")
    t_part = time.perf_counter()
    bf16 = bf16_training()
    parts_s["bf16 training"] = time.perf_counter() - t_part
    lo, hi = bf16["step_ms_range"]
    print(f"    bf16 training, train/loss by epoch {[round(v, 4) for v in bf16['losses']]} "
          f"against [9]'s f32 {[round(v, 4) for v in train['losses']]}; test "
          f"{ {k: round(v, 4) for k, v in bf16['test'].items()} }")
    print(f"    bf16 train step: median {bf16['step_ms']:.1f} ms (range {lo:.1f}-{hi:.1f}), "
          f"{bf16['images_per_s']:.1f} images/s against [9]'s f32 {train['step_ms']:.1f} ms, "
          f"{train['images_per_s']:.1f} images/s ({train['step_ms'] / bf16['step_ms']:.2f}x); "
          f"peak {bf16['peak_gib']:.2f} GiB against {train['peak_gib']:.2f}; calls "
          f"{bf16['calls']} ((K2, K1, K3) {bf16['per_call']}); {bf16['wall_s']:.1f} s, on {card}")
    print(f"    prefetcher: [9] fed by {train['feed']}, bf16 run by {bf16['feed']}; the card's "
          f"first epoch ({bf16['first_epoch_batches']} batches) in the library's host order; "
          f"data wait (PhaseTimer 'data') bf16 {bf16['data_wait']}, [9] {train['data_wait']}")
    t_part = time.perf_counter()
    bk16 = bf16_kernel_checks(bf16.pop("trainer"), bf16.pop("val"))
    parts_s["bf16 kernel checks"] = time.perf_counter() - t_part
    r = bk16["k2"]
    print(f"    K2 at {r['shape']} {r['dtype']} (the bf16-trained head's logits, cast): mu err "
          f"{r['err']['mu_px']:.3e} px, sigma rel err {r['err']['sigma_rel']:.3e}; "
          f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}), plain "
          f"{r['plain_ms']:.4f} ms; RowMoments gradient {bk16['grad_dtype']}, "
          f"{bk16['grad_rel_err']:.2e} of the largest from f64 (bar {BF16_GRAD_BAR:.2e}), "
          f"backward {bk16['bwd_ms']:.4f} ms (bound {bk16['bwd_bound_ms']:.4f} ms by "
          f"{bk16['bwd_bound_by']})")
    t_part = time.perf_counter()
    bstep = bf16_step_check()
    parts_s["bf16 step check"] = time.perf_counter() - t_part
    print(f"    one bf16 SGD step (64^2, 4 stages) against f64 (relative L2 of all gradients; "
          f"bars {BF16_STEP_BARS}): card {bstep['card']}, CPU {bstep['cpu']}; card vs CPU "
          f"{bstep['card_vs_cpu_l2']:.3e}; of {bstep['activations']} activations")
    print(f"    [16] seconds by part: { {k: round(v, 1) for k, v in parts_s.items()} }")
    shutil.rmtree(ENSEMBLE_DIR, ignore_errors=True)

    phase_start[17] = time.perf_counter()
    print("[17] several ranks through torch.distributed: two ranks spawned on this card over "
          "gloo, (a) data-parallel SGD steps of [9]'s model and global batch, (b) "
          f"view-parallel run_predict of {MULTI_CFG['views']} views at [5]'s configuration, "
          "(c) one view in the latency mode (predict_sample_parallel=2: the MC-dropout tail "
          "in row blocks, K2 on each rank's rows, the sampler on each rank's T_a share) and "
          "one view of [12]'s mcdropout through SegPredictor, each against one process on "
          "the card")
    multi = multi_rank_phase()
    chk = multi["gloo_check"]
    print(f"    one process {multi['one_s']:.1f} s; two gloo ranks on {multi['gloo'][0]['card']} "
          f"(devices {[r['device'] for r in multi['gloo']]}, backend "
          f"{multi['gloo'][0]['backend']}) {multi['gloo_s']:.1f} s including their start-up")
    for r in multi["gloo"]:
        print(f"    rank {r['rank']}: launches (K2, K1, K3) train {r['train']['launches']}, "
              f"serve {r['serve']['launches']}, latency {r['latency']['launches']}, "
              f"segmentation view {r['seg_latency']['launches']}; seconds train "
              f"{r['train']['s']:.1f}, serve {r['serve']['s']:.1f}, latency "
              f"{r['latency']['s']:.1f}, segmentation view {r['seg_latency']['s']:.1f}")
    for who, rows in [("one process", multi["one"])] + [
            (f"rank {r['rank']}", r) for r in multi["gloo"]]:
        lat = rows["latency"]["rows"]
        print(f"    (c) {who}: MC-dropout tail rows per call {lat['tail']}, K2 launches "
              f"(heatmaps, bands) {lat['k2']}, K3 contours {lat['k3']}; segmentation view "
              f"tail rows {rows['seg_latency']['rows']['tail']}")
    print(f"    (a) {MULTI_CFG['steps']} SGD steps, global batch {TRAIN_CFG['batch']} on mesh "
          f"{multi['gloo'][0]['train']['mesh']}: each leaf's update against one process's "
          f"within {chk['ddp_worst_share']:.3f} of its bar at worst ({STEP_BARS['grad_leaf']} "
          f"of the leaf + {STEP_BARS['zero_grad']} of the largest); losses (ranks' mean) "
          f"{[round(v, 5) for v in np.mean([r['train']['losses'] for r in multi['gloo']], 0)]} "
          f"against {[round(v, 5) for v in multi['one']['train']['losses']]}; both ranks' "
          "weights equal")
    print(f"    (b) {MULTI_CFG['views']} views, every output bitwise one process's; rank 1 "
          "returned none")
    print(f"    (c) latency mode against one process: "
          f"{ {k: float(f'{v:.3e}') for k, v in chk['latency_err'].items()} } (bars "
          f"{LATENCY_BARS}); samples bitwise: {chk['latency_samples_bitwise']}; all "
          f"{len(multi['one']['latency']['digests'])} outputs bitwise (sha256), and the "
          f"mcdropout view's {len(multi['one']['seg_latency']['digests'])} through "
          "SegPredictor")
    if "nccl" in multi:
        one_rate = multi["one"]["serve"]["views_per_s"]
        two_rate = multi["nccl"][0]["serve"]["views_per_s"]
        print(f"    NCCL, one rank per card: checks as above {multi['nccl_check']}; views/s "
              f"one card {one_rate:.2f}, two cards {two_rate:.2f} ({two_rate / one_rate:.2f}x), "
              f"on {card}")
    else:
        print(f"    NCCL at world size 1: all-reduce of ones(4) = {multi['nccl_world_1']}; the "
              "multi-card run (NCCL, one rank per card, views/s on one card against two) was "
              f"skipped: {torch.cuda.device_count()} card visible, it needs a second")
    r = multi["empty"]
    print(f"    (d) four ranks' shards in this process: tail rows {r['tail_rows']}, samples "
          f"{r['samples']} (T_a 2); concatenated bitwise one process's (tail "
          f"{r['tail_bitwise']}, samples {r['samples_bitwise']}); generators left elsewhere "
          f"than one process's: {r['generators_moved']}; an empty share's (K2, K3) launches "
          f"{r['empty_launches']}, outputs {r['empty_shapes']}")
    r = multi["k3"]
    print(f"    K3 at one rank's share of a view {r['shape']}: bitwise, {r['ms']:.4f} ms (bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
          f"torch.topk {r['library_ms']:.4f} ms, on {card}")
    r = multi["k2"]
    print(f"    K2 at one rank's rows of a view {r['shape']} {r['dtype']}: {r['err']} against "
          f"f64, {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}), plain "
          f"{r['plain_ms']:.4f} ms, on {card}")

    phase_start[18] = time.perf_counter()
    print("[18] figures and the prediction writer on [5]'s 6 views: the processors that draw, "
          "calibration and prediction_writer on the card and on the CPU, the dashboards' "
          "payloads card vs CPU, val_figure")
    figs = figure_phase(main_res)
    print(f"    this machine: matplotlib {'present' if figs['matplotlib'] else 'absent'}, h5py "
          f"{'present' if figs['h5py'] else 'absent'}; figure_errors {figs['figure_errors']}; "
          f"processor_errors {figs['processor_errors']}; clinical_metrics/metric_figures_error "
          f"{figs['metric_figures_error']!r}; {len(figs['card_pngs'])} PNGs on the card, as on "
          f"the CPU")
    print(f"    card vs CPU: {len(figs['csvs'])} CSVs within {PROCESSOR_TOL} (areas and FAC "
          f"equal), {', '.join(figs['npys'])} equal; processors' host time "
          f"{figs['host_ms_per_view']:.1f} ms per view, launches (K2, K1, K3) "
          f"{figs['processor_launches']}")
    pm = sorted(figs["payload_ms"])
    sp = figs["splines"]
    print(f"    dashboard payloads, dense splines {sp['shape']} an instant (f64 solve): card "
          f"within {sp['max']:.2e} px of the CPU on all {sp['samples']} samples (bar "
          f"{SPLINE_BAR_PX:.0e}), {sp['max_f64']:.2e} px from an f64 evaluation on the CPU; "
          f"masks, images and metric infos equal")
    print(f"    payload ms per view on the card: median {pm[len(pm) // 2]:.2f} (range "
          f"{pm[0]:.2f}-{pm[-1]:.2f}, first call included) on {card}")
    print(f"    val_figure: {'a figure' if figs['matplotlib'] else 'ModuleNotFoundError'}; "
          f"launches (K2, K1, K3) {figs['val_figure_launches']}")

    for kern in kernels:
        short = kern["name"].split(" ")[0]
        kern["jsrt"] = {name: {"launches": row["launches"][short],
                               "launches_per_view": row["launches"][short] / row["views"]}
                        for name, row in jsrt.items()}
        kern["jsrt"]["training_launches_per_step"] = jtrain["per_step"][short]
        kern["jsrt"]["launches_per_val_batch"] = jtrain["per_val_batch"][short]
        if short == "K2":
            kern["jsrt"]["kernel"] = {"serving": jk["k2_serving"], "training": jk["k2_training"]}
        if short == "K3":
            kern["jsrt"]["kernel"] = jk["k3"]
        kern["epistemic"] = {"launches": seg["epistemic"]["launches"][short],
                             "launches_per_view":
                                 seg["epistemic"]["launches"][short] / seg["epistemic"]["views"],
                             "training_launches_per_step":
                                 seg_train["epistemic"]["launches"][short] / SEG_TRAIN_STEPS}
        kern["segmentation"] = {name: {"launches": seg[name]["launches"][short],
                                       "training_launches": seg_train[name]["launches"][short]}
                                for name in SEG_CFG}
        per_call = {label: calls[{"K2": 0, "K1": 1, "K3": 2}[short]]
                    for label, calls in train["per_call"].items()}
        kern["training"] = {"launches": train["totals"][short], "launches_per_call": per_call}
        if short == "K2":
            kern["training"].update({k: grads[k] for k in (
                "shape", "fwd_ms", "fwd_bound_ms", "fwd_bound_by", "plain_fwd_ms",
                "plain_bwd_ms", "bwd_bound_ms", "bwd_bound_by", "grad_rel_err", "max_abs_err",
                "moment_err")})
            kern["training"]["trained_head_err"] = head_errs
        index = {"K2": 0, "K1": 1, "K3": 2}[short]
        kern["skew"] = {
            "launches": skew["launches"][short],
            "launches_per_view": skew["launches"][short] / skew["views"],
            "training_launches": skew_train["totals"][short],
            "launches_per_call": {label: calls[index] for label, calls in SKEW_PER_CALL.items()}}
        if short == "K2":
            kern["skew"].update({"head_logits_err": skew_k["k2_err"],
                                 "max_abs_err": skew_k["k2_max_abs_err"]})
        if short == "K3":
            kern["skew"].update({k: skew_k[k] for k in (
                "level_contours", "narrow_levels", "min_area_px", "k3_ms", "k3_plain_ms",
                "k3_library_ms", "k3_bound_ms", "k3_bound_by")})
        kern["sequence"] = {name: {"launches": run["launches"][short],
                                   "launches_per_view": run["launches"][short] / run["views"]}
                            for name, run in seq.items()}
        kern["batched"] = {name: {"views_per_dispatch": BATCH_VIEWS,
                                  "dispatches": row["dispatches"],
                                  "launches": sum(d[index] for d in row["per_dispatch"]),
                                  "launches_per_dispatch": [d[index] for d in row["per_dispatch"]]}
                           for name, row in batch.items()}
        if short in ("K2", "K3"):
            kern["batched"]["kernel"] = bk[short.lower()]
        kern["camus"] = {name: {"launches": row["launches"][short],
                                "launches_per_view": row["launches"][short] / row["views"]}
                         for name, row in camus.items()}
        kern["camus"]["LV+MYO training_launches_per_step"] = ctrain["per_step"][short]
        kern["backbones"] = {name: {"launches": row["launches"][short],
                                    "launches_per_view": row["launches"][short] / row["views"],
                                    **({"training_launches_per_step":
                                        row["train"]["per_step"][short]}
                                       if "train" in row else {})}
                             for name, row in bb.items()}
        if short == "K2":
            kern["camus"]["kernel"] = {"lv_myo": ck["k2_lv_myo"], "deeplabv3": ck["k2_deeplabv3"]}
        if short == "K3":
            kern["camus"]["kernel"] = ck["k3_lv_myo"]
        kern["ensemble"] = {
            "members": ENSEMBLE_MEMBERS, "launches": ens["run"]["launches"][short],
            "launches_per_view": ens["run"]["launches"][short] / ens["run"]["views"],
            "batched_launches_per_dispatch": [d[index] for d in ens["batched"]["per_dispatch"]],
            "skew_launches_per_view": ens["skew_launches"][short],
            "training_launches_per_call": {label: calls[index] for label, calls
                                           in ens_train["per_call"].items()}}
        kern["bf16_training"] = {"launches_per_call": {label: calls[index] for label, calls
                                                       in bf16["per_call"].items()}}
        if short in ("K2", "K3"):
            kern["ensemble"]["kernel"] = ens[short.lower()]
        if short == "K2":
            kern["bf16_training"]["kernel"] = bk16
        kern["figures"] = {"processors_launches": figs["processor_launches"][index],
                           "val_figure_launches": figs["val_figure_launches"][index],
                           "matplotlib": figs["matplotlib"]}
        kern["multi_rank"] = {
            f"rank {r['rank']}": {label: r[label]["launches"][short]
                                  for label in ("train", "serve", "latency")}
            for r in multi["gloo"]}
        if short == "K3":
            kern["multi_rank"]["kernel_per_rank_share"] = multi["k3"]
    phase_start[19] = time.perf_counter()
    print(f"[19] ConvLayer epilogue kernels at unet2's plane shapes (batch {EPILOGUE_BATCH}) "
          f"vs the plain f32 chain and f64")
    epilogue = epilogue_phase()
    per_step = lambda e: [e["forward"], e["backward"]]
    train_runs = {"training": train["epilogue"], "skew": skew_train["epilogue"],
                  "ensemble": ens_train["epilogue"], "bf16": bf16["epilogue"],
                  "jsrt": jtrain["epilogue_per_step"],
                  "camus LV+MYO": ctrain["epilogue_per_step"],
                  **{f"segmentation {name}": row["epilogue_per_step"]
                     for name, row in seg_train.items()},
                  **{f"backbone {name}": row["train"]["epilogue_per_step"]
                     for name, row in bb.items() if "train" in row}}
    paths = {**{k: per_step(e) for k, e in train_runs.items()},
             **{f"multi_rank rank {r['rank']}": [v / MULTI_CFG["steps"]
                                                for v in per_step(r["train"]["epilogue"])]
                for r in multi["gloo"]}}
    kernels.append(epilogue_kernel_entry(epilogue, paths))
    print(f"    launches (forward, backward) per train step: {paths}")
    phase_start[20] = time.perf_counter()
    print(f"[20] DeepLabV3's norm chains at its plane shapes (batch {EPILOGUE_BATCH}) vs the "
          f"plain f32 chain and f64; launches per DeepLabV3 train step")
    kernels.append(norm_chain_kernel_entry(norm_chain_phase()))
    phase_start[21] = time.perf_counter()
    print(f"[21] the 1x1 convolutions' weight gradient kernel at DeepLabV3's and the UNet's 1x1 "
          f"shapes (batch {WGRAD_BATCH}) vs f64, cuDNN and matmul; launches per train step")
    wgrad_paths = {k: e["wgrad"] for k, e in train_runs.items()}
    print(f"    kernel launches per train step on the training paths: {wgrad_paths}")
    kernels.append(wgrad_kernel_entry(wgrad_phase(), wgrad_paths))

    t_end = time.perf_counter()
    starts = sorted(phase_start.items())
    spans = {f"[{n}]": round(b - a, 1) for (n, a), (_, b) in zip(starts, starts[1:] + [(0, t_end)])}
    print(f"    seconds per phase ([1] includes [2]'s build): {spans}")
    print(f"    total {t_end - t_start:.1f} s")
    left = live_children()
    if left:
        raise AssertionError(f"processes this run started are still running: {left}")
    print("    processes this run started still running: none")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
