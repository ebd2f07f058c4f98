"""Builds the port's native libraries from the sources in the checkout.

Everything is built at first use into `contouring_uncertainty_torch/_build/`
(git-ignored), never at import:

- CUDA C++ sources under `csrc/` (the hand-written kernels) are compiled by
  `nvcc` for `sm_90a` into a shared library with a plain C interface,
  loaded with ctypes. Each source has its own flags beside the common ones
  (`CUDA_SOURCES`).
- The host C++ batch prefetcher (`csrc/prefetch_loader.cpp`,
  `HOST_SOURCES`) is compiled by `g++ -O3 -shared -fPIC -std=c++17
  -pthread`, as the JAX package builds its copy. A failed build prints the
  JAX package's message and gives None: the trainer then batches with numpy.

A library's file name carries a hash of its source and flags, so an edited
source or flag is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

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
# separate mul and add (bitwise parity). dsnt_moments and conv_epilogue are
# held to tolerances: contraction into FMAs stays on (conv_epilogue rounds
# its kink test with explicit intrinsics, the same in both its kernels).
CUDA_SOURCES = {
    "min_k_crossings": ("min_k_crossings.cu", ["--fmad=false", "-prec-div=true"]),
    "dsnt_moments": ("dsnt_moments.cu", ["--fmad=true"]),
    "conv_epilogue": ("conv_epilogue.cu", ["--fmad=true"]),
}

# name -> (source file under csrc/, g++ flags): host libraries.
HOST_SOURCES = {
    "prefetch_loader": ("prefetch_loader.cpp",
                        ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]),
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


def _hashed_path(name: str, source: str, flags: List[str]) -> Path:
    digest = hashlib.sha256((CSRC_DIR / source).read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def library_path(name: str) -> Path:
    return _hashed_path(name, CUDA_SOURCES[name][0], nvcc_flags(name))


def host_library_path(name: str) -> Path:
    return _hashed_path(name, *HOST_SOURCES[name])


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


def build_host_library(name: str) -> Optional[Path]:
    """Compile csrc/<source> with g++ into a shared library unless it is
    built. On a failed build (or no g++) print the JAX package's message and
    return None."""
    out = host_library_path(name)
    if out.exists():
        return out
    source, flags = HOST_SOURCES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *flags, "-o", str(tmp), str(CSRC_DIR / source)]
    try:
        proc = subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as exc:
        BUILD_LOGS[name] = getattr(exc, "stderr", None) or str(exc)
        print(f"[native] build of {name} failed ({exc}); using Python fallback")
        return None
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def build_all() -> List[Optional[Path]]:
    """Build every library, one compiler per source, all started together:
    the CUDA libraries (a failure raises), then the host libraries (None for
    one whose build failed)."""
    jobs = [(build_cuda_library, n) for n in CUDA_SOURCES]
    jobs += [(build_host_library, n) for n in HOST_SOURCES]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = [pool.submit(fn, n) for fn, n in jobs]
        return [f.result() for f in futures]
