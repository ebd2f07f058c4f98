"""BENCHMARK.json against the files it names, and the harness's
extensibility: a configuration, a traffic mix and a metric added as new
files are found with no edit of a file that is there."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return harness.Manifest(REPO / "BENCHMARK.json")


def test_manifest_keys_and_names(manifest):
    data = manifest.data
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert data["paths"] == ["portbench"] and data["command"][1] == "portbench/run.py"
    names = [c["name"] for c in data["configs"]] + [w["name"] for w in data["workloads"]] + [
        m["name"] for m in data["end_to_end"] + data["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in data["end_to_end"] + data["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in data["end_to_end"])
    assert len(json.dumps(data)) < 64 * 1024


def test_every_cell_resolves(manifest):
    for w in manifest.data["workloads"]:
        cell = manifest.cell(w["name"])
        config = manifest.config(cell["config"])
        traffic = manifest.traffic(cell["traffic"])
        assert hasattr(manifest.driver(traffic["driver"]), "run")
        assert config["dtype"] == "float32" and config["tf32"] is False
        assert config["task"]["t_e"] == 10 and config["task"]["t_a"] == 25
        assert config["model"]["drop_block"] is True
        limits = json.loads((manifest.root / "limits" / f"{w['name']}.json").read_text())
        assert limits, w["name"]
        reported = {m["name"] for m in manifest.end_to_end(w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layered = manifest.per_layer(w["name"])
        assert layered and all(m["moves"] in reported for m in layered)
    for m in manifest.data["per_layer"]:
        assert hasattr(manifest.metric_reader(m["name"]), "read")


def test_config_reduced_lists_the_cuts(manifest):
    for entry in manifest.data["configs"]:
        config = manifest.config(entry["name"])
        assert entry["reduced"] == config["reduced"]
        for key in config["reduced"]:
            assert config["published"][key] != config["data"][key]


def test_new_files_are_found_without_edits(tmp_path, manifest):
    root = tmp_path / "portbench"
    shutil.copytree(manifest.root, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "camus-dsnt-al-t5.json").write_text(
        json.dumps({**manifest.config("camus-dsnt-al"), "name": "camus-dsnt-al-t5"}))
    (root / "traffic" / "train-b16.json").write_text(
        json.dumps({**manifest.traffic("train"), "batch_size": 16}))
    (root / "metrics" / "window_traced.py").write_text(
        "def read(reading, ctx):\n    return None if reading is None else reading.window_s\n")
    data = json.loads(json.dumps(manifest.data))
    data["configs"].append({"name": "camus-dsnt-al-t5", "source": "x",
                            "file": "portbench/configs/camus-dsnt-al-t5.json", "reduced": [],
                            "why": "x"})
    data["workloads"].append({"name": "camus-dsnt-al-t5.train-b16", "config": "camus-dsnt-al-t5",
                              "traffic": "train-b16", "chips": 1, "why": "x"})
    data["per_layer"].append({"name": "window_traced", "unit": "s", "better": "higher",
                              "source": "device_trace", "layer": "x", "moves": "setup_s",
                              "workloads": ["camus-dsnt-al-t5.train-b16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    m = harness.Manifest(tmp_path / "BENCHMARK.json", root=root)
    cell = m.cell("camus-dsnt-al-t5.train-b16")
    assert m.config(cell["config"])["name"] == "camus-dsnt-al-t5"
    assert m.traffic(cell["traffic"])["batch_size"] == 16
    assert [x["name"] for x in m.per_layer(cell["name"])] == ["window_traced"]
    assert m.metric_reader("window_traced").read(None, None) is None
    assert all(p.read_bytes() == b for p, b in before.items())
