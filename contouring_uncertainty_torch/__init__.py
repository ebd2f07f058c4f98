"""PyTorch/CUDA port of contouring_uncertainty_tpu for NVIDIA Hopper.

The JAX package beside it stays the reference; this package mirrors its
module tree and names so each counterpart is easy to find, but imports
nothing of it (nor JAX). Plain tensor code is PyTorch; every Pallas kernel
of the JAX package is a hand-written Hopper kernel here:

- ops/dsnt_kernel.py: Triton online-softmax DSNT moment kernel (replaces
  ops/pallas_dsnt.py's row and column kernels);
- csrc/min_k_crossings.cu: CUDA C++ exact min-k scanline crossing
  selection (replaces ops/pallas_select.py), bound with ctypes.

Public entry points run on the GPU (`device="cuda"`) unless the caller asks
for the CPU; on the CPU every kernel wrapper uses its plain PyTorch version.
"""

__version__ = "0.1.0"
