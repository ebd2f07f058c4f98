"""On the card: each cell's control (the plain reference with TF32
convolutions, one precision below the configuration's) is not correct by
the cell's limits, and the program on the same seed is. At the cells' own
sizes, one seed each."""

import json
from pathlib import Path

import pytest

from portbench import control, harness

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    manifest = harness.Manifest(REPO / "BENCHMARK.json")
    limits = json.loads((manifest.root / "limits" / f"{cell}.json").read_text())
    out = control.readings(manifest, cell, 2 ** 31 + 101, 3.0, True, device=card)
    assert all(out["numbers"][k] <= v for k, v in limits.items()), out["numbers"]
    assert any(out["control"].get(k, 0.0) > v for k, v in limits.items()), out["control"]
