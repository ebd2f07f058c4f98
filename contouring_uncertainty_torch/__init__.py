"""PyTorch/CUDA port of contouring_uncertainty_tpu for NVIDIA Hopper.

The JAX package beside it stays the reference; this package mirrors its
module tree and names so each counterpart is easy to find, but imports
nothing of it (nor JAX). Plain tensor code is PyTorch; every Pallas kernel
of the JAX package is a hand-written Hopper kernel here:

- csrc/dsnt_moments.cu: CUDA C++ online-softmax DSNT moment kernels, one
  for heatmaps stored as rows and one for heatmaps stored as columns
  (replace ops/pallas_dsnt.py's two kernels), bound with ctypes through
  ops/dsnt_kernel.py;
- csrc/min_k_crossings.cu: CUDA C++ exact min-k scanline crossing
  selection (replaces ops/pallas_select.py), bound with ctypes through
  ops/select_kernel.py.

Two slices of the flagship run are ported: serving (`predict.run_predict`)
and DSNT-AL training (`runner.run`, `train.Trainer`). Public entry points
run on the GPU (`device="cuda"`) unless the caller asks for the CPU; on the
CPU every kernel wrapper uses its plain PyTorch version.
"""

__version__ = "0.1.0"
