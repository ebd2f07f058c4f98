"""Parent-against-change serving speed of the port on one card: the seed of
the port's GPU benchmark, which is to grow its cells from here.

Runs serving phases of chip_smoke.py for each checkout given, in its own
process, one checkout after another, on the checkout's own package and
chip_smoke.py (each builds its kernels there):

- [5] `main_path`: the flagship 8-stage UNet at 256^2, bf16, T_e = 10,
  T_a = 25, the 6 test views of 8 synthetic patients (a warm-up run, then
  5 timed passes); one view's forwards with the DSNT head
  (`task.predict`) profiled (the summed device time of its kernels) and
  timed on the host (median of 10 calls); the served mu and cov of every
  view saved to DIR_OUT/ab_<i>.npz;
- [10] `skew_serving`: DSNTSkew at [5]'s width (esn, 3 timed passes);
- [12] mcdropout: `seg_task("mcdropout")` at [5]'s width through `serve`
  (3 timed passes);
- [13] `jsrt_serving`: DSNT-AL, mcdropout and dsnt-skew5 on the JSRT
  synthetic films (3 timed passes each).

    python3 bench_torch/ab.py OUT DIR [DIR ...]

DIR is the root of a checkout; list them in the order they should run
(parent, change, change, parent compares two trees on one card). Prints
the card's name and power limit, one JSON line per run, then the largest
mu and cov differences at [5] between each pair of runs. Needs a CUDA GPU.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

RUN = r"""
import json, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from contouring_uncertainty_torch import build
from contouring_uncertainty_torch.predict import view_generator

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_all()
out = {}
main = cs.main_path()
np.savez(sys.argv[1], mu=np.stack([r.mu for r in main["results"]]),
         cov=np.stack([r.cov for r in main["results"]]))
view = next(iter(main["data"].predict_views("test")))
img = torch.as_tensor(view["img"], device="cuda")


@torch.inference_mode()
def forward():
    return main["task"].predict(main["model"], img, view_generator(cs.MAIN_CFG["seed"], 0))


forward()
host_ms = []
for _ in range(10):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forward()
    torch.cuda.synchronize()
    host_ms.append(1e3 * (time.perf_counter() - t0))
kernel_ms, copy_ms, _ = cs.profile_run(forward)
rate = lambda r: {"views_per_s": r["views_per_s"], "ms_per_view": r["ms_per_view"],
                  "ms_range": r.get("ms_range", r.get("ms_per_view_range")),
                  "device_ms_per_view": r["kernel_ms_per_view"]}
out["[5]"] = {**rate(main), "forward_device_ms": kernel_ms, "forward_copy_ms": copy_ms,
              "forward_host_ms": sorted(host_ms)[len(host_ms) // 2]}
del main
torch.cuda.empty_cache()
out["[10]"] = rate(cs.skew_serving())
torch.cuda.empty_cache()
data = cs.camus_data(cs.MAIN_CFG["n_patients"], cs.MAIN_CFG["size"], cs.MAIN_CFG["seed"])
task = cs.seg_task("mcdropout", data.data_params)
model = task.build_model(device="cuda",
                         generator=torch.Generator().manual_seed(cs.MAIN_CFG["seed"]))
run = cs.serve(task, model, data, {"seed": cs.MAIN_CFG["seed"]}, cs.SEG_PASSES)
out["[12] mcdropout"] = rate({**run, **cs.rate(run, run["pass_s"])})
del model, run
torch.cuda.empty_cache()
for name, row in cs.jsrt_serving(cs.jsrt_data()).items():
    out[f"[13] {name}"] = rate(row)
print("AB " + json.dumps(out))
"""


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir, dirs = Path(argv[0]).resolve(), argv[1:]
    out_dir.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    failed, saved = 0, {}
    for i, d in enumerate(dirs):
        npz = out_dir / f"ab_{i}.npz"
        proc = subprocess.run([sys.executable, "-c", RUN, str(npz)], cwd=Path(d),
                              capture_output=True, text=True)
        lines = [l for l in proc.stdout.splitlines() if l.startswith("AB ")]
        if proc.returncode or not lines:
            failed += 1
            print(f"run {i} ({d}) failed, exit {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                  f"{proc.stderr[-3000:]}")
            continue
        print(json.dumps({"run": i, "dir": str(d), **json.loads(lines[-1][3:])}), flush=True)
        saved[i] = np.load(npz)
    for a, b in itertools.combinations(sorted(saved), 2):
        gap = {k: float(np.abs(saved[a][k].astype(np.float64) - saved[b][k]).max())
               for k in ("mu", "cov")}
        print(json.dumps({"runs": [a, b], "dirs": [dirs[a], dirs[b]], "[5] max_abs": gap,
                          "cov_scale": float(np.abs(saved[a]["cov"]).max())}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
