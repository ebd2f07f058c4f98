"""The port's kernel build (contouring_uncertainty_torch/build.py): each CUDA
source's own nvcc flags, and the library path that carries them. Nothing is
compiled here (this machine has no nvcc)."""

import pytest

from contouring_uncertainty_torch import build


@pytest.mark.parametrize("name", sorted(build.CUDA_SOURCES))
def test_each_source_is_built_for_hopper_from_csrc(name):
    flags = build.nvcc_flags(name)
    assert (build.CSRC_DIR / build.CUDA_SOURCES[name][0]).is_file()
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--use_fast_math" not in flags
    assert build.library_path(name).parent == build.BUILD_DIR


def test_each_source_has_its_own_flags():
    """The crossing selection keeps --fmad=false and IEEE division (bitwise
    parity with its plain version); the moment kernel, held to tolerances,
    keeps FMA contraction."""
    select = build.nvcc_flags("min_k_crossings")
    assert "--fmad=false" in select and "-prec-div=true" in select
    moments = build.nvcc_flags("dsnt_moments")
    assert "--fmad=false" not in moments and "--fmad=true" in moments


def test_library_path_follows_each_sources_flags(monkeypatch):
    """Changing one source's flags changes its library's path (so a stale
    build is never loaded) and leaves the other source's path as it was."""
    before = {name: build.library_path(name) for name in build.CUDA_SOURCES}
    assert len(set(before.values())) == len(before)
    src, _ = build.CUDA_SOURCES["dsnt_moments"]
    monkeypatch.setitem(build.CUDA_SOURCES, "dsnt_moments", (src, ["--fmad=false"]))
    assert build.library_path("dsnt_moments") != before["dsnt_moments"]
    assert build.library_path("min_k_crossings") == before["min_k_crossings"]
