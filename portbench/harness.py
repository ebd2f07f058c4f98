"""The benchmark's machinery: the manifest and the files it names, the
import isolation checks, a run's context, and the result's line.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric is a file of its own, found by the name BENCHMARK.json
gives it:

- configs/<config>.json   the configuration's sizes and precision;
- traffic/<traffic>.json  a traffic mix: its `driver` and that driver's
                          parameters;
- drivers/<driver>.py     `run(ctx)`, which builds the program, warms it,
                          measures the window and checks the outputs;
- metrics/<metric>.py     `read(reading)`, a per-layer metric from the
                          traced part (None where it finds nothing);
- limits/<cell>.json      the limits of the numbers that decide `correct`;
- reference/<model_name>.py  a backbone's plain forward, initialisation
                          rule and FLOP count (reference/unet2.py says
                          what each gives), by the configuration's
                          `model_name`.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent  # portbench/
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "contouring_uncertainty_tpu", "chip_smoke", "bench",
             "bench_torch")
PROGRAM = "contouring_uncertainty_torch"


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name, compared whole,
    is one the benchmark may not load."""
    return sorted(name for name in sys.modules if name.split(".")[0] in FORBIDDEN)


def reference_imports(root: Path = ROOT) -> List[str]:
    """Imports of the program (top-level name compared whole) in the
    sources under reference/: there must be none."""
    found = []
    for path in sorted((root / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            found += [f"{path.name}: {n}" for n in names if n.split(".")[0] == PROGRAM]
    return found


def import_all(root: Path = ROOT) -> None:
    """Import every module of the harness: its own, the reference, the
    drivers and the metric readers."""
    import importlib

    for name in ("films", "work", "weights", "devtrace", "check", "program"):
        importlib.import_module(f"portbench.{name}")
    for path in sorted((root / "reference").glob("*.py")):
        importlib.import_module(f"portbench.reference.{path.stem}")
    for sub in ("drivers", "metrics"):
        for path in sorted((root / sub).glob("*.py")):
            load_module(path)


def load_module(path: Path) -> ModuleType:
    """A harness file as a module of its own (names may hold dots)."""
    name = "portbench_" + path.parent.name + "_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Manifest:
    """BENCHMARK.json and the files it names under `root`."""

    def __init__(self, path: Path = REPO / "BENCHMARK.json", root: Path = ROOT):
        self.data = json.loads(Path(path).read_text())
        self.repo = Path(path).resolve().parent
        self.root = Path(root)

    def cell(self, name: str) -> Dict[str, Any]:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        return json.loads((self.repo / entry["file"]).read_text())

    def traffic(self, name: str) -> Dict[str, Any]:
        return json.loads((self.root / "traffic" / f"{name}.json").read_text())

    def driver(self, name: str) -> ModuleType:
        return load_module(self.root / "drivers" / f"{name}.py")

    def end_to_end(self, cell: str) -> List[Dict[str, Any]]:
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict[str, Any]]:
        """The per-layer metrics the cell reports: those listing it, and
        those without a list whose end-to-end metric the cell reports."""
        mine = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in mine)]

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.root / "metrics" / f"{name}.py")

    def backbone(self, model_name: str) -> ModuleType:
        """The plain reference of a configuration's backbone."""
        return load_module(self.root / "reference" / f"{model_name}.py")


def cpu_cut(config: Dict[str, Any]) -> Dict[str, Any]:
    """The configuration at the size its CPU tests run: each section of its
    `cpu_cut` laid over the section of that name."""
    out = json.loads(json.dumps(config))
    for section, overrides in config["cpu_cut"].items():
        out[section].update(overrides)
    return out


@dataclass
class Context:
    """One run: what it measures and what it has measured so far."""

    cell: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    backbone: ModuleType  # reference/<model_name>.py
    values: Dict[str, float] = field(default_factory=dict)  # end-to-end metrics
    attempted: int = 0
    failed: int = 0
    reading: Optional[Any] = None  # trace.Reading of the traced part
    numbers: Dict[str, float] = field(default_factory=dict)  # what decides `correct`
    control: Dict[str, float] = field(default_factory=dict)  # the control's readings
    memory_peak_bytes: int = 0
    spans: Dict[str, List[float]] = field(default_factory=dict)

    def setup_done(self):
        """Set-up ends here: the next operation is the first timed one."""
        self.values["setup_s"] = time.perf_counter() - self.t_start

    def memory_peak(self):
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())


def set_environment(root: Path = REPO):
    """Caches inside the checkout at fixed paths, and no JAX through
    libraries that would load it."""
    cache = root / ".portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
