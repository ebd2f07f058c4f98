"""Process-group initialization, host batch slices and the one-process-per-
device launcher.

Counterpart of contouring_uncertainty_tpu/parallel/distributed.py on
`torch.distributed`. One JAX process drives every chip of its host; the
torch idiom is one process per GPU, so a run on several GPUs is several
processes joined in one process group: started by torchrun, by a SLURM
step, or by `spawn` (the runner's `main` and the tests use it).

`initialize` is a no-op for a single process: it opens no socket unless a
multi-process job is described by its arguments or the environment, so the
training stack calls it unconditionally.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from contouring_uncertainty_torch.device import DeviceLike, resolve_device

# How long a collective (and a rendezvous) waits before it fails; a hung
# rank then raises instead of blocking its peers for ever.
DEFAULT_TIMEOUT_S = 600.0
# How long `rank0_first`'s other ranks wait for rank 0 to fill a cache (a
# contour cache of a whole CAMUS split, a shape prior): work of minutes to
# hours, not a collective.
CACHE_TIMEOUT_S = 6 * 3600.0


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def _init_method(address: str) -> str:
    """`host:port` (the JAX coordinator's form) -> tcp://host:port; a URL
    (tcp://, file://, env://) as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: DeviceLike = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join this process to the process group of a multi-process run.

    Resolution order (first match wins), as the JAX package's:
    1. explicit arguments (`coordinator_address` is host:port or an
       init-method URL such as file:///path or tcp://host:port);
    2. CUTPU_COORDINATOR / CUTPU_NUM_PROCESSES / CUTPU_PROCESS_ID;
    3. torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR (env://);
    4. a SLURM step of SLURM_NTASKS > 1 tasks (SLURM_PROCID, SLURM_LOCALID),
       its address from CUTPU_COORDINATOR or MASTER_ADDR:MASTER_PORT.

    Returns False for a single process (nothing is opened), True once a
    process group exists; a second call returns True. The rank's device is
    `device` (cuda unless the caller asks for the CPU; cuda without an
    index is cuda:LOCAL_RANK), a CUDA device made current before any
    collective.
    `backend` defaults to nccl on CUDA and gloo on the CPU; gloo on CUDA
    (two ranks sharing one card, which NCCL refuses) only when named.
    Every collective fails after `timeout_s` seconds."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("CUTPU_COORDINATOR")
    if num_processes is None and env.get("CUTPU_NUM_PROCESSES"):
        num_processes = int(env["CUTPU_NUM_PROCESSES"])
    if process_id is None and env.get("CUTPU_PROCESS_ID"):
        process_id = int(env["CUTPU_PROCESS_ID"])
    local_rank = env.get("LOCAL_RANK")
    if coordinator_address is None and "RANK" in env and "MASTER_ADDR" in env:
        coordinator_address = "env://"  # torchrun
        num_processes = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(env["RANK"]) if process_id is None else process_id
    elif int(env.get("SLURM_NTASKS", "1") or "1") > 1:
        num_processes = int(env["SLURM_NTASKS"]) if num_processes is None else num_processes
        process_id = int(env["SLURM_PROCID"]) if process_id is None else process_id
        local_rank = env.get("SLURM_LOCALID", local_rank)
        if coordinator_address is None:
            if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
                raise ValueError(f"a SLURM step of {num_processes} tasks needs the rendezvous "
                                 "address: set CUTPU_COORDINATOR=host:port, or MASTER_ADDR "
                                 "and MASTER_PORT")
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None:
        return False  # a single process: nothing to do
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {coordinator_address!r} given without the number of "
                         "processes and this process's id")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(local_rank) if local_rank is not None else process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    return True


def process_batch_slice(global_batch: int) -> slice:
    """The half-open range of the global batch this process loads: rank p
    of P owns items [p * B/P, (p + 1) * B/P). The global batch must divide
    evenly across the processes."""
    n_proc = world_size()
    if global_batch % n_proc:
        raise ValueError(f"global batch {global_batch} not divisible by {n_proc} hosts")
    per = global_batch // n_proc
    p = rank()
    return slice(p * per, (p + 1) * per)


def shard_host_batch(batch: Dict, mesh) -> Dict:
    """A batch as this process's shard of the global one. A single process
    takes its mesh rows (`mesh.shard_batch`); with several processes each
    has loaded its own `process_batch_slice` rows, which are its shard as
    they are."""
    from contouring_uncertainty_torch.parallel.mesh import shard_batch

    if world_size() == 1:
        return shard_batch(batch, mesh)
    return dict(batch)


def rank0_first(fn: Callable[[], Any]) -> Any:
    """fn() on rank 0, then, once it has returned, on every other rank:
    for work that fills a cache file (a shape prior, a contour cache) that
    the other ranks then read instead of writing it at the same time. The
    others wait up to CACHE_TIMEOUT_S (on a gloo group of their own), not
    the collectives' timeout. Every rank must call it."""
    if world_size() == 1:
        return fn()
    group = dist.new_group(backend="gloo", timeout=timedelta(seconds=CACHE_TIMEOUT_S))
    try:
        if rank() == 0:
            out = fn()
            dist.barrier(group=group)
            return out
        dist.barrier(group=group)
        return fn()
    finally:
        dist.destroy_process_group(group)


# A spawned rank's interpreter: the parent's sys.path, then `_rank_main`.
_RANK_CODE = ("import json, sys; sys.path[:] = json.load(open(sys.argv[1])); "
              "from contouring_uncertainty_torch.parallel.distributed import _rank_main; "
              "_rank_main(sys.argv[2], int(sys.argv[3]))")


def _die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when its parent exits (Linux), so
    a parent that is killed leaves no rank behind."""
    try:
        import ctypes
        import signal

        ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        return
    if os.getppid() != parent:
        os._exit(1)


def _load_main(main: Dict[str, Optional[str]]) -> None:
    """Load the parent's __main__ (by module name under `python -m`, else
    from its file, as __mp_main__ so its main guard stays off) and alias it
    as __main__, so that what the parent pickled from its __main__ (the
    rank's function) unpickles here."""
    import importlib
    import runpy
    import types

    if main["name"]:
        module = importlib.import_module(main["name"])
    else:
        module = types.ModuleType("__mp_main__")
        module.__dict__.update(runpy.run_path(main["path"], run_name="__mp_main__"))
    sys.modules["__main__"] = sys.modules["__mp_main__"] = module


def _rank_main(spec_path: str, rank_: int) -> None:
    """A spawned rank: join the group, run fn(device, *args), write (ok,
    its result or the traceback) to its result file, leave the group."""
    spec = pickle.loads(Path(spec_path).read_bytes())
    _die_with_parent(spec["parent"])
    if spec["main"] is not None:
        _load_main(spec["main"])
    out = Path(spec["results"]) / f"rank{rank_}.pkl"
    try:
        fn, args = pickle.loads(spec["call"])
        device = spec["devices"][rank_]
        initialize(spec["init_method"], len(spec["devices"]), rank_, backend=spec["backend"],
                   device=device, timeout_s=spec["timeout_s"])
        result = pickle.dumps((True, fn(torch.device(device), *args)))
    except Exception:  # reported to the parent, which raises it
        result = pickle.dumps((False, traceback.format_exc()))
    try:
        tmp = out.with_suffix(".tmp")
        tmp.write_bytes(result)
        os.replace(tmp, out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _main_spec(fn: Callable) -> Optional[Dict[str, Optional[str]]]:
    """How a rank finds the parent's __main__ (None when fn lives in an
    importable module)."""
    if getattr(fn, "__module__", None) != "__main__":
        return None
    main = sys.modules["__main__"]
    spec = getattr(main, "__spec__", None)
    name = spec.name if spec is not None and spec.name != "__main__" else None
    if name is None and not getattr(main, "__file__", None):
        raise ValueError(f"{fn!r} is defined in an interactive __main__: spawn needs a "
                         "function a new interpreter can import")
    return {"name": name, "path": getattr(main, "__file__", None)}


def _stop(procs: List[subprocess.Popen], grace_s: float) -> None:
    """Wait up to `grace_s` for each process to exit, then kill it and reap
    it: no rank outlives `spawn`."""
    end = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(timeout=max(0.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def spawn(fn: Callable, world_size_: int, backend: Optional[str] = None,
          init_file: Optional[str] = None, args: Sequence = (),
          devices: Optional[Sequence[str]] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S,
          deadline_s: Optional[float] = None) -> List[Any]:
    """Run fn(device, *args) in `world_size_` new processes, one rank each,
    joined in one process group through a file:// rendezvous at
    `init_file` (a fresh path; by default one in a temporary directory).

    Rank r runs on devices[r] (default cuda:r; give "cpu" for gloo ranks on
    the CPU, or the same card twice with backend="gloo"). Each rank is a new
    interpreter of the parent's sys.path: fn must be importable by its
    module path (or defined in the parent's main script or `-m` module),
    and fn, args and fn's value must pickle. Returns the ranks' values in
    rank order. A rank's collectives fail after `timeout_s` seconds. A rank
    that raises or dies, or, where `deadline_s` is given, a run longer than
    that, raises RuntimeError here after every rank is stopped; by default a
    run may take as long as its work takes. Every rank has exited when spawn
    returns or raises, and a rank dies with its parent."""
    devices = [f"cuda:{r}" for r in range(world_size_)] if devices is None else list(devices)
    if len(devices) != world_size_:
        raise ValueError(f"{world_size_} ranks need as many devices, got {devices}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        path = Path(init_file) if init_file else tmp / "rendezvous"
        (tmp / "path.json").write_text(json.dumps(sys.path))
        (tmp / "spec.pkl").write_bytes(pickle.dumps({
            "parent": os.getpid(), "main": _main_spec(fn), "results": str(tmp),
            "call": pickle.dumps((fn, tuple(args))), "devices": devices, "backend": backend,
            "init_method": f"file://{path.resolve()}", "timeout_s": timeout_s}))
        procs: List[subprocess.Popen] = []
        got: Dict[int, Any] = {}
        deadline = None if deadline_s is None else time.monotonic() + deadline_s
        try:
            for r in range(world_size_):
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _RANK_CODE, str(tmp / "path.json"),
                     str(tmp / "spec.pkl"), str(r)], stdin=subprocess.DEVNULL))
            while len(got) < world_size_:
                for r, p in enumerate(procs):
                    out = tmp / f"rank{r}.pkl"
                    if r in got:
                        continue
                    exited = p.poll() is not None
                    if out.exists():
                        ok, value = pickle.loads(out.read_bytes())
                        if not ok:
                            raise RuntimeError(f"rank {r} of {world_size_} failed:\n{value}")
                        got[r] = value
                    elif exited:
                        raise RuntimeError(f"rank {r} exited with code {p.returncode} "
                                           "without a result")
                if deadline is not None and time.monotonic() > deadline and len(got) < world_size_:
                    raise RuntimeError(f"ranks {sorted(set(range(world_size_)) - set(got))} "
                                       f"gave no result within {deadline_s} s")
                time.sleep(0.1)
        finally:
            # Ranks that have given their result leave the group and exit; after a
            # failure the others may wait in a collective, so they are stopped now.
            _stop(procs, 30.0 if len(got) == world_size_ else 0.0)
    return [got[r] for r in range(world_size_)]


def gather_to_rank0(obj: Any) -> Optional[List[Any]]:
    """Every rank's picklable `obj` (numpy, not CUDA tensors), in rank order,
    on rank 0; None on the other ranks and [obj] for a single process."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size() if rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out

