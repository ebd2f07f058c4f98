"""Builds the port's hand-written kernels from the sources in the checkout.

Everything is built at first use into `contouring_uncertainty_torch/_build/`
(git-ignored), never at import:

CUDA C++ sources under `csrc/` are compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface, loaded with ctypes. Each source has
its own flags beside the common ones (`CUDA_SOURCES`). The library's file
name carries a hash of its source and flags, so an edited source or flag is
rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# Hopper only: `sm_90a` keeps wgmma/setmaxnreg available to later kernels.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# name -> (source file under csrc/, that source's own nvcc flags).
# min_k_crossings: --fmad=false (no mul-add contraction) and IEEE division,
# so crossing abscissae round exactly like the plain PyTorch version's
# separate mul and add (bitwise parity). dsnt_moments is held to tolerances:
# contraction into FMAs stays on.
CUDA_SOURCES = {
    "min_k_crossings": ("min_k_crossings.cu", ["--fmad=false", "-prec-div=true"]),
    "dsnt_moments": ("dsnt_moments.cu", ["--fmad=true"]),
}

# Compiler output (ptxas register/shared-memory report) of the last build.
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def nvcc_flags(name: str) -> List[str]:
    """The nvcc flags of one source: the common ones, then its own."""
    return [*NVCC_FLAGS, *CUDA_SOURCES[name][1]]


def library_path(name: str) -> Path:
    src = CSRC_DIR / CUDA_SOURCES[name][0]
    digest = hashlib.sha256(src.read_bytes() + " ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_cuda_library(name: str) -> Path:
    """Compile csrc/<source> into a shared library unless it is built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *nvcc_flags(name), "-o", str(tmp),
           str(CSRC_DIR / CUDA_SOURCES[name][0])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{BUILD_LOGS[name]}")
    os.replace(tmp, out)
    return out


def build_all() -> List[Path]:
    """Build every CUDA library, one nvcc per source, all started together."""
    with ThreadPoolExecutor(max_workers=len(CUDA_SOURCES)) as pool:
        futures = [pool.submit(build_cuda_library, n) for n in CUDA_SOURCES]
        return [f.result() for f in futures]
