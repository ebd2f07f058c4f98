"""Device ops: DSNT heads, splines, rasterization and the wrappers of the
CUDA C++ kernels (ops/dsnt_kernel.py, ops/select_kernel.py)."""
