"""Readings for the limits of `correct`: a cell's numbers on many seeds,
and the control's, in one process.

    python3 portbench/control.py --workload <cell> --seeds 11,12,... \
        --control-seeds 11,12,13 --seconds 3

For each seed the cell's driver runs as a benchmark run does (set-up, a
window of `--seconds`, the check) at the cell's own sizes; on the
control's seeds it also puts the control in the program's place: the
plain reference with TF32 convolutions, one precision below the
configuration's float32 with TF32 off, read against the reference. With
`--fault` a fault of faults.py is planted in the program first. Each seed
prints one JSON line: {"seed", "numbers", "control", "values"}. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == REPO / "portbench":
    sys.path[0] = str(REPO)
else:
    sys.path.insert(0, str(REPO))


def readings(manifest, cell_name: str, seed: int, seconds: float, control: bool,
             device: str = "cuda") -> dict:
    import torch

    from portbench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.cell(cell_name)
    traffic = manifest.traffic(cell["traffic"])
    config = manifest.config(cell["config"])
    ctx = harness.Context(cell=cell_name, config=config, traffic=traffic, seed=seed,
                          seconds=seconds, trace=False, device=device,
                          t_start=time.perf_counter(),
                          backbone=manifest.backbone(config["model_name"]))
    manifest.driver(traffic["driver"]).run(ctx, control=control)
    return {"seed": seed, "numbers": ctx.numbers, "control": ctx.control,
            "values": ctx.values}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--fault", default="", help="a fault of faults.py planted in the program")
    args = parser.parse_args()
    from portbench import harness

    harness.set_environment(REPO)
    manifest = harness.Manifest(REPO / "BENCHMARK.json")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    if args.fault:
        from portbench import faults

        faults.plant(args.fault)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(manifest, args.workload, seed, args.seconds, seed in controls)
        out["seconds"] = time.perf_counter() - t0
        out["fault"] = args.fault
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
