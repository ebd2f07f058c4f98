"""BENCHMARK.json against the files it names, and the harness's
extensibility: a configuration of another backbone (with its reference
module), a traffic mix and a metric added as new files are found with no
edit of a file that is there."""

import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness, weights

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
        backbone = manifest.backbone(config["model_name"])
        assert not [f for f in harness.reference_imports(manifest.root)
                    if f.startswith(f"{config['model_name']}.py:")]
        assert callable(backbone.forward) and callable(backbone.init)
        size, k = config["data"]["size"], 2 * config["data"]["points_per_side"] - 1
        assert backbone.train_flops((1, size, size), k, config["model"]) > 0
        cut = harness.cpu_cut(config)
        assert set(config["cpu_cut"]) <= {"model", "data"} and cut["data"]["size"] < size
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


TOY = """\
import torch.nn.functional as F

from portbench.work import ConvShape, conv_flops


def forward(w, x, model, drop=None):
    x = F.conv2d(x, w["Conv_0.weight"], padding=1)
    if drop is not None:
        x = x * (drop((x.shape[0], x.shape[1], 1, 1)) < 0.5) / 0.5
    x = F.group_norm(x, x.shape[1], w["GroupNorm_0.weight"], w["GroupNorm_0.bias"])
    return F.conv2d(F.relu(x), w["Conv_1.weight"])


def init(name, shape):
    if name.endswith(".weight") and len(shape) == 4:
        return "normal", 1.0 / (shape[1] * shape[2] * shape[3])
    return "constant", 1.0 if name == "GroupNorm_0.weight" else 0.0


def train_flops(in_shape, n_classes, model):
    c, h, w = in_shape
    convs = [ConvShape("stem", c, model["width"], 3, 3, h, w),
             ConvShape("head", model["width"], n_classes, 1, 1, h, w)]
    return 3.0 * sum(map(conv_flops, convs)) - conv_flops(convs[0])
"""


def test_new_files_are_found_without_edits(tmp_path, manifest):
    """A second configuration, of another `model_name` with its toy
    reference module, a traffic mix and a metric, all new files: the
    manifest finds each, the backbone's forward, initialisation rule and
    FLOP count by its `model_name`, its CPU cut from its own file."""
    root = tmp_path / "portbench"
    shutil.copytree(manifest.root, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "camus-dsnt-al-t5.json").write_text(
        json.dumps({**manifest.config("camus-dsnt-al"), "name": "camus-dsnt-al-t5"}))
    (root / "configs" / "camus-toy.json").write_text(json.dumps({
        **manifest.config("camus-dsnt-al"), "name": "camus-toy", "model_name": "toynet",
        "model": {"width": 8, "dtype": "float32"},
        "cpu_cut": {"model": {"width": 4}, "data": {"size": 16, "n_patients": 4}}}))
    (root / "reference" / "toynet.py").write_text(TOY)
    (root / "traffic" / "train-b16.json").write_text(
        json.dumps({**manifest.traffic("train"), "batch_size": 16}))
    (root / "metrics" / "window_traced.py").write_text(
        "def read(reading, ctx):\n    return None if reading is None else reading.window_s\n")
    data = json.loads(json.dumps(manifest.data))
    for name in ("camus-dsnt-al-t5", "camus-toy"):
        data["configs"].append({"name": name, "source": "x", "reduced": [], "why": "x",
                                "file": f"portbench/configs/{name}.json"})
    data["workloads"].append({"name": "camus-dsnt-al-t5.train-b16", "config": "camus-dsnt-al-t5",
                              "traffic": "train-b16", "chips": 1, "why": "x"})
    data["workloads"].append({"name": "camus-toy.train", "config": "camus-toy",
                              "traffic": "train", "chips": 1, "why": "x"})
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

    config = m.config(m.cell("camus-toy.train")["config"])
    toy = m.backbone(config["model_name"])
    assert harness.reference_imports(root) == []
    shapes = {"Conv_0.weight": torch.Size([8, 1, 3, 3]), "GroupNorm_0.weight": torch.Size([8]),
              "GroupNorm_0.bias": torch.Size([8]), "Conv_1.weight": torch.Size([21, 8, 1, 1])}
    w = weights.make(shapes, 2 ** 32 + 5, "cpu", toy.init)
    assert list(w) == list(shapes)
    assert torch.equal(w["GroupNorm_0.weight"], torch.ones(8))
    assert torch.equal(w["GroupNorm_0.bias"], torch.zeros(8))
    for name, fan_in in (("Conv_0.weight", 9), ("Conv_1.weight", 8)):
        # The normal of variance 1 / fan_in, truncated at 2 of its std.
        bound = 2 / fan_in ** 0.5 / weights._TRUNC_STD
        assert 0.5 * bound < float(w[name].abs().max()) <= bound * (1 + 1e-6)
    x = torch.rand(2, 1, 16, 16, generator=torch.Generator().manual_seed(0))
    assert toy.forward(w, x, config["model"]).shape == (2, 21, 16, 16)
    assert toy.train_flops((1, 16, 16), 21, config["model"]) == (
        3 * 2 * (9 * 8 + 8 * 21) - 2 * 9 * 8) * 256
    cut = harness.cpu_cut(config)
    assert cut["model"] == {"width": 4, "dtype": "float32"}
    assert (cut["data"]["size"], cut["data"]["n_patients"]) == (16, 4)
    assert config["model"]["width"] == 8 and config["data"]["size"] == 256
    assert all(p.read_bytes() == b for p, b in before.items())
