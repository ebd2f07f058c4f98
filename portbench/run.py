"""The benchmark of the PyTorch and CUDA port (`contouring_uncertainty_torch`).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process: it builds the program and the cell's inputs and
weights from the seed, warms up the cell's shapes, measures for
`--seconds`, checks the outputs against the plain reference and prints
one JSON line last on standard output. With `--trace 0` the line holds the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics, read
from a traced part of the window. A run without a CUDA card, or with
fewer cards than the cell asks for, exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == REPO / "portbench":
    sys.path[0] = str(REPO)
else:
    sys.path.insert(0, str(REPO))


def fail(message: str, code: int = 2):
    print(f"portbench: {message}", file=sys.stderr)
    sys.exit(code)


def measure(args, manifest, require_card: bool = True, device: str = "cuda") -> dict:
    """One run of a cell -> the result's dict (without printing it)."""
    import torch

    from portbench import check, harness, work

    cell = manifest.cell(args.workload)
    if require_card:
        if not torch.cuda.is_available():
            fail("no CUDA card: the benchmark measures the port on the card only")
        if torch.cuda.device_count() < cell["chips"]:
            fail(f"the cell needs {cell['chips']} cards, {torch.cuda.device_count()} found")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traffic = manifest.traffic(cell["traffic"])
    config = manifest.config(cell["config"])
    ctx = harness.Context(cell=cell["name"], config=config, traffic=traffic, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace), device=device,
                          t_start=T_START, backbone=manifest.backbone(config["model_name"]))
    manifest.driver(traffic["driver"]).run(ctx)

    found = harness.forbidden_modules()
    if found:
        fail(f"modules the benchmark may not load are loaded: {found}", 3)
    ok, checks = check.judge(ctx.numbers, check.load_limits(manifest.root, ctx.cell))
    if args.trace:
        reading = ctx.reading
        metrics = {}
        for m in manifest.per_layer(ctx.cell):
            value = manifest.metric_reader(m["name"]).read(reading, ctx)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": ctx.values[m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(ctx.cell)}
    card = work.card_line() if require_card else ""
    result = {
        "correct": ok, "attempted": ctx.attempted, "failed": ctx.failed, "metrics": metrics,
        "device": {"platform": "gpu" if device.startswith("cuda") else "cpu",
                   "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": ctx.memory_peak_bytes,
                   "card": card, "tf32": False},
    }
    if args.trace and ctx.reading is not None:
        result["device"]["busy_s"] = ctx.reading.busy_s()
        result["device"]["window_s"] = ctx.reading.window_s
        result["breakdown"] = ctx.reading.breakdown()
    result["checks"] = check.report(checks)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        from portbench import harness
    except ImportError as exc:
        fail(f"the benchmark's files are incomplete: {exc}")
    harness.set_environment(REPO)
    harness.import_all()
    if harness.reference_imports():
        fail(f"the plain reference imports the program: {harness.reference_imports()}", 3)
    try:
        import contouring_uncertainty_torch as program
    except ImportError as exc:
        fail(f"the program is not in this checkout: {exc}")
    if not Path(program.__file__).resolve().is_relative_to(REPO):
        fail(f"the program loaded from {program.__file__}, not from this checkout")
    if harness.forbidden_modules():
        fail(f"modules the benchmark may not load are loaded: {harness.forbidden_modules()}", 3)
    result = measure(args, harness.Manifest(REPO / "BENCHMARK.json"))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
