"""Device ops: DSNT heads, splines, rasterization and the two kernels
(ops/dsnt_kernel.py, Triton; ops/select_kernel.py, CUDA C++)."""
