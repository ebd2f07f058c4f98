"""The PyTorch port stands alone: it imports no JAX (its multi-GPU modules
under parallel/ included), nothing of the JAX package and none of h5py (but inside the JSRT and CAMUS readers' load
functions, the writers and the raw-data generators), PIL (but inside the
generators' resize), matplotlib, pandas, PyYAML and orbax; its entry points
default to the GPU and raise without one instead of carrying on on the CPU;
and chip_smoke.py refuses to run without a card or outside a checkout.
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import contouring_uncertainty_torch as port
from contouring_uncertainty_torch import factory, runner
from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch.config import compose
from contouring_uncertainty_torch.data.synthetic import synthetic_camus_data
from contouring_uncertainty_torch.device import resolve_device
from contouring_uncertainty_torch.results import run_processors
from contouring_uncertainty_torch.sampler import PosteriorShapeModelSampler, fit_shape_prior
from contouring_uncertainty_torch.tasks import DSNTAleatoric
from contouring_uncertainty_torch.train import Trainer, TrainerConfig

REPO = Path(__file__).resolve().parents[1]
PACKAGE = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "contouring_uncertainty_tpu", "h5py",
             "matplotlib", "yaml", "pandas", "PIL")
SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3, drop_block=True)


def _port_sources():
    return sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


# The one exception: the JSRT and CAMUS readers' load functions, the
# writers and the raw-data generators import h5py inside themselves, as the
# JAX package's do (the machine with the card has no h5py and feeds the
# readers from arrays).
H5PY_FUNCTIONS = {PACKAGE / "data" / "lung.py": {"_load", "write_jsrt_hdf5"},
                  PACKAGE / "data" / "camus.py": {"_split_patients", "load_split"},
                  PACKAGE / "data" / "synthetic.py": {"write_camus_hdf5"},
                  PACKAGE / "data" / "generators.py": {"generate_camus", "generate_jsrt"}}
# Package -> the functions that may import it inside themselves, by module.
LOCAL_IMPORTS = {"h5py": H5PY_FUNCTIONS,
                 "PIL": {PACKAGE / "data" / "generators.py": {"_resize"}}}


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_no_forbidden_import_statement(path):
    """AST scan of every module of the package and of chip_smoke.py, at any
    depth (function-local imports included): no forbidden import, but for
    h5py and PIL inside the functions of LOCAL_IMPORTS."""
    tree = ast.parse(path.read_text(), filename=str(path))
    allowed = {name: set() for name in LOCAL_IMPORTS}
    for name, functions in LOCAL_IMPORTS.items():
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef) and fn.name in functions.get(path, ()):
                allowed[name] |= {id(node) for node in ast.walk(fn)}
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in FORBIDDEN
                  and id(node) not in allowed.get(n.split(".")[0], ())]
    assert not found, f"{path.relative_to(REPO)} imports {found}"
    for name, functions in LOCAL_IMPORTS.items():
        if path in functions:
            assert len(allowed[name]) > 0


def test_importing_the_port_loads_no_jax():
    """In a fresh interpreter (this one has JAX loaded by tests/conftest.py),
    importing every module of the package and chip_smoke leaves JAX, the
    JAX package, h5py, matplotlib and pandas out of sys.modules."""
    modules = sorted(
        "contouring_uncertainty_torch." + ".".join(p.relative_to(PACKAGE).with_suffix("").parts)
        for p in PACKAGE.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


PARALLEL = ("distributed", "mesh", "serving")


def test_parallel_package_imports_no_jax():
    """The multi-GPU modules (parallel/distributed.py, mesh.py, serving.py)
    are among the scanned sources, and importing them in a fresh
    interpreter loads no forbidden module and opens no process group: the
    ranks that `distributed.spawn` starts import them without JAX."""
    files = {PACKAGE / "parallel" / f"{name}.py" for name in PARALLEL}
    assert files <= set(_port_sources())
    code = (
        "import json, sys\n"
        + "".join(f"import contouring_uncertainty_torch.parallel.{n}\n" for n in PARALLEL)
        + "import torch.distributed as dist\n"
        f"print(json.dumps([dist.is_initialized()] + sorted(m for m in sys.modules "
        f"if m.split('.')[0] in {FORBIDDEN!r})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [False]


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    """Without a GPU, every public entry point called without `device`
    raises (the serving path's, the trainer, the factory's build_trainer
    and runner.run of the training path, and the results processors'
    run_processors); `device="cpu"` is the only way onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = synthetic_camus_data(n_patients=5, size=64, seed=0)
    task = DSNTAleatoric(data_params=data.data_params, t_e=1, t_a=2, model_kwargs=SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        task.build_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    model = task.build_model(device="cpu")
    prior = fit_shape_prior(data.train_arrays("train")["contour"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PosteriorShapeModelSampler(prior)
    sampler = PosteriorShapeModelSampler(prior, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpred.AleatoricPredictor(task, model, sampler)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpred.run_predict(task, model, data, {"seed": 0})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(task, TrainerConfig())
    cfg = compose(["data=synthetic", "data.image_size=64", "data.n_patients=5"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory.build_trainer(cfg, task)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.run(["data=synthetic", "data.image_size=64", "data.n_patients=5"])
    assert factory.build_trainer(cfg, task, device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_processors([], tmp_path, {"data": {"results_processors": ["instant_metrics"]}})
    assert run_processors([], tmp_path, {"data": {"results_processors": []}}, device="cpu") == {}


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script-alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line when CUDA is
    unavailable (as on this CPU-only machine), from the checkout and from a
    directory holding the script alone."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the smoke run would use it")
    cwd = REPO
    if alone:
        cwd = tmp_path
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
