"""The benchmark loads neither JAX nor the JAX package nor the repo's
older timing scripts, its reference imports nothing of the program, and a
run without a card, or without the program, exits non-zero and prints no
result."""

import shutil
import subprocess
import sys
from pathlib import Path

from portbench import harness

REPO = Path(__file__).resolve().parents[2]


def test_harness_modules_load_nothing_forbidden():
    code = ("import sys; sys.path.insert(0, %r); from portbench import harness; "
            "harness.import_all(); import portbench.run; "
            "print(harness.forbidden_modules())" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("benchmarking_unrelated", type(sys)("benchmarking_unrelated"))
    try:
        assert "benchmarking_unrelated" not in harness.forbidden_modules()
    finally:
        del sys.modules["benchmarking_unrelated"]


def test_reference_imports_nothing_of_the_program(tmp_path):
    assert harness.reference_imports() == []
    root = tmp_path / "portbench"
    (root / "reference").mkdir(parents=True)
    (root / "reference" / "bad.py").write_text(
        "from contouring_uncertainty_torch.ops import dsnt\nimport contouring_uncertainty_tpu\n")
    assert harness.reference_imports(root) == ["bad.py: contouring_uncertainty_torch.ops"]


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "camus-dsnt-al.train", "--seed", "4294967311", "--seconds", "1",
                           *extra], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_exits_nonzero_without_a_result():
    out = _run(REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_benchmark_files_alone_exit_nonzero(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
