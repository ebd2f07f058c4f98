"""A run with its timed path broken underneath comes out not correct.

The drivers run whole (set-up, window, check against the reference) on
the CPU at a tiny size: each configuration cut by its own `cpu_cut`
(camus-dsnt-al: 64x64 films of 10 patients, a 4-stage UNet), batches of
4. The look for a card is skipped.
Each fault is planted in the program and must make `correct` false; the
same run without it must come out correct."""

import json
import shutil
from argparse import Namespace
from pathlib import Path

import pytest
import torch

from portbench import faults, harness

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiny")
    root = tmp / "portbench"
    shutil.copytree(REPO / "portbench", root, ignore=shutil.ignore_patterns("__pycache__"))
    for path in (root / "configs").glob("*.json"):
        path.write_text(json.dumps(harness.cpu_cut(json.loads(path.read_text()))))
    t = json.loads((root / "traffic" / "train.json").read_text())
    (root / "traffic" / "train.json").write_text(json.dumps({**t, "batch_size": 4}))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return harness.Manifest(tmp / "BENCHMARK.json", root=root)


def _correct(manifest, cell):
    import portbench.run as run

    torch.set_num_threads(2)
    args = Namespace(workload=cell, seed=2 ** 32 + 17, seconds=0.5, trace=0)
    return run.measure(args, manifest, require_card=False, device="cpu")["correct"]


CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
CASES = [(c, f) for c in CELLS for f in (None, *faults.TRAINING)]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_fault_makes_the_run_not_correct(tiny, cell, fault):
    remove = faults.plant(fault) if fault else (lambda: None)
    try:
        assert _correct(tiny, cell) is (fault is None)
    finally:
        remove()
