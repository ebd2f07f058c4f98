"""PyTorch port vs JAX package: the results processors (results/) on the
same BatchResults, and the slice as a whole through runner.run on the CPU.

The BatchResults come from the port's run_predict on the CPU (64^2, a
4-stage UNet, T_e=2, T_a=4, two test patients with both views) and are
converted to the JAX package's BatchResult with its own Label. Both
packages run point_metrics, calibration, clinical_metrics,
instant_metrics, mutual_info and sigma_stats; their CSVs (read with
pandas, here only), .npy dicts and metrics.json are compared. The JAX
package's `matplotlib.pyplot.savefig` and per-view dashboards are switched
off while it runs, which changes none of its numbers; the port draws its
figures (held against JAX's in tests/test_torch_port_figures.py).

Tolerances: every value that does not come from the clinical metrics'
device reductions is computed by the same numpy code on the same inputs and
must be equal, as must the clinical areas and FAC (integer pixel counts).
GLS, volumes and EF and what derives from them (their stds, errors,
correlations and UCE) are held to 1e-5 + 5e-5 * |value|: the spline
perimeters and the Simpson volumes reduce in f32 in another order (see
tests/test_torch_port_clinical.py).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from contouring_uncertainty_tpu.data import config as jc
from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch import runner
from contouring_uncertainty_torch.data.config import BatchResult, Label
from contouring_uncertainty_torch.data.synthetic import synthetic_camus_data
from contouring_uncertainty_torch.results import run_processors
from contouring_uncertainty_torch.results.utils import Table
from contouring_uncertainty_torch.tasks import DSNTAleatoric

torch.set_num_threads(1)

SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3, drop_block=True)
PROCESSORS = ["point_metrics", "calibration", "clinical_metrics", "instant_metrics",
              "mutual_info", "sigma_stats"]
CSVS = ["instant_metrics.csv", "clinical/instant_df.csv", "clinical/view_df.csv",
        "clinical/patient_df.csv", "clinical/volume_df.csv"]
# Keys the JAX package writes only when a figure fails.
FIGURE_ONLY = ("clinical_metrics/metric_figures_error",)


def _device_reduced(name: str) -> bool:
    """Values downstream of the clinical f32 reductions (GLS, volumes, EF)."""
    return any(m in name for m in ("GLS", "EDV", "ESV", "EF", "Volume"))


def _close(got, ref, name):
    if isinstance(ref, (bool, str)) or ref is None:
        assert got == ref, name
        return
    if _device_reduced(name):
        np.testing.assert_allclose(got, ref, rtol=5e-5, atol=1e-5, err_msg=name)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=name)


def to_jax(res: BatchResult) -> jc.BatchResult:
    fields = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}
    fields["labels"] = tuple(jc.Label(int(label)) for label in res.labels)
    return jc.BatchResult(**fields)


def run_jax_processors(results, out_dir, cfg):
    """The JAX package's run_processors with figure output switched off."""
    import matplotlib.pyplot as plt

    from contouring_uncertainty_tpu.results import metric_figures, run_processors as j_run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(plt, "savefig", lambda *args, **kwargs: None)
        mp.setattr(metric_figures, "render_dashboards", lambda *args, **kwargs: None)
        return j_run([to_jax(r) for r in results], out_dir, cfg)


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    data = synthetic_camus_data(n_patients=10, size=64, seed=1)
    task = DSNTAleatoric(data_params=data.data_params, t_e=2, t_a=4, model_kwargs=SMALL)
    model = task.build_model(device="cpu", generator=torch.Generator().manual_seed(0))
    cfg = {"seed": 3, "task": {"psm_path": str(tmp_path_factory.mktemp("prior") / "p.npz")}}
    results = tpred.run_predict(task, model, data, cfg, device="cpu")
    assert len(results) == 4 and {r.id.rpartition("/")[2] for r in results} == {"2CH", "4CH"}
    return results


@pytest.fixture(scope="module")
def both(views, tmp_path_factory):
    """(port metrics, port dir, JAX metrics, JAX dir) on the same views."""
    cfg = {"data": {"results_processors": PROCESSORS}}
    t_dir, j_dir = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("jax")
    got = run_processors(views, t_dir, cfg, device="cpu")
    ref = run_jax_processors(views, j_dir, cfg)
    return got, t_dir, ref, j_dir


def test_metrics_json_matches_jax(both):
    got, t_dir, ref, _ = both
    assert "processor_errors" not in got and "processor_errors" not in ref
    ref = {k: v for k, v in ref.items() if k not in FIGURE_ONLY}
    assert set(got) == set(ref)
    for prefix in PROCESSORS:
        assert any(k.startswith(prefix + "/") for k in got), prefix
    for key in ("clinical_metrics/Area_uce", "clinical_metrics/GLS_a-uce",
                "clinical_metrics/Volume_uce", "point_metrics/monoticity_Error-cov_det"):
        assert np.isfinite(got[key]), key
    for key, value in ref.items():
        _close(got[key], value, key)
    written = json.loads((t_dir / "metrics.json").read_text())
    assert set(written) == set(got)
    assert written["clinical_metrics/Area_uce"] == got["clinical_metrics/Area_uce"]


@pytest.mark.parametrize("name", CSVS)
def test_csvs_match_jax(both, name):
    """Same index, columns and dtypes as the JAX package's CSV; values
    equal, or within the stated tolerance downstream of the device
    reductions. Where no value is device-reduced the text is identical."""
    _, t_dir, _, j_dir = both
    got_text, ref_text = (t_dir / name).read_text(), (j_dir / name).read_text()
    got, ref = pd.read_csv(t_dir / name, index_col=0), pd.read_csv(j_dir / name, index_col=0)
    assert list(got.index) == list(ref.index) and list(got.columns) == list(ref.columns)
    assert list(got.dtypes) == list(ref.dtypes)
    assert len(ref) > 0
    for col in ref.columns:
        if ref[col].dtype.kind in "fi":
            assert np.array_equal(np.isnan(got[col]), np.isnan(ref[col])), col
            ok = ~np.isnan(ref[col].to_numpy(float))
            _close(got[col].to_numpy(float)[ok], ref[col].to_numpy(float)[ok], col)
        else:
            assert got[col].tolist() == ref[col].tolist(), col
    if not any(_device_reduced(c) for c in ref.columns):
        assert got_text == ref_text
    if name == "clinical/volume_df.csv":
        assert [i.rpartition("/")[2] for i in got.index] == ["ES", "ES", "ED", "ED"]


@pytest.mark.parametrize("name", ["data_instant.npy", "data_point.npy", "sigma_stats.npy"])
def test_npy_dicts_match_jax(both, name):
    _, t_dir, _, j_dir = both
    got = np.load(t_dir / name, allow_pickle=True).item()
    ref = np.load(j_dir / name, allow_pickle=True).item()
    assert got.keys() == ref.keys()
    for key, value in ref.items():
        if isinstance(value, dict):
            assert got[key].keys() == value.keys()
            for k, v in value.items():
                np.testing.assert_array_equal(np.asarray(got[key][k]), np.asarray(v), err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=key)


def test_mask_gls_branch_matches_jax(views, tmp_path):
    """BatchResults without contour samples (the segmentation baselines'
    form) take the mask-space GLS: the ED/ES label maps of every sample,
    with MYO among the labels, and the one view without a reference."""
    rng = np.random.default_rng(4)
    results = []
    for res in views[:2]:
        samples = res.pred_samples.copy()
        ring = rng.random(samples.shape) < 0.5
        ring &= np.roll(samples, 2, axis=-2) != samples  # a band at the edge: MYO
        samples[ring] = 2
        results.append(dataclasses.replace(
            res, contour_samples=None, pred_samples=samples,
            labels=(Label.BG, Label.LV, Label.MYO),
            gt=res.gt if res is views[0] else None))
    cfg = {"data": {"results_processors": ["clinical_metrics"]}}
    got = run_processors(results, tmp_path / "port", cfg, device="cpu")
    ref = run_jax_processors(results, tmp_path / "jax", cfg)
    assert "processor_errors" not in got and "processor_errors" not in ref
    table = pd.read_csv(tmp_path / "port" / "clinical" / "view_df.csv", index_col=0)
    ref_table = pd.read_csv(tmp_path / "jax" / "clinical" / "view_df.csv", index_col=0)
    assert list(table.columns) == list(ref_table.columns)
    assert np.isfinite(table["GLS_mean"]).all() and np.isnan(table["GLS_gt"].iloc[1])
    for col in [c for c in ref_table.columns if c.startswith("GLS_")]:
        if ref_table[col].dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(table[col]), np.isnan(ref_table[col]))
        _close(table[col].to_numpy(), ref_table[col].to_numpy(), col)
    ref = {k: v for k, v in ref.items() if k not in FIGURE_ONLY}
    assert set(got) == set(ref)
    for key, value in ref.items():
        _close(got[key], value, key)


def test_unported_and_unknown_processors_are_recorded(views, tmp_path):
    """An unknown processor name is recorded as such; the others still
    run."""
    names = ["instant_metrics", "no_such_processor"]
    got = run_processors(views, tmp_path, {"data": {"results_processors": names}},
                         device="cpu")
    errors = got["processor_errors"]
    assert errors == {"no_such_processor": "unknown processor (not registered)"}
    assert "instant_metrics/Dice" in got
    assert json.loads((tmp_path / "metrics.json").read_text())["processor_errors"] == errors


TABLES = {
    "mixed": {"a/ED": {"x": 1.0, "flag": True, "g": np.nan}, "b/ES": {"flag": False, "z": 4.5,
                                                                     "x": 0.1}},
    "floats": {"p1": {"v": 2.0 / 3.0, "w": np.float32(0.1)}, "p2": {"v": 1e-20, "w": -0.0}},
    "nan_column": {"u": {"x": 1.0, "y": np.nan}, "v": {"x": np.inf, "y": np.nan}},
}


@pytest.mark.parametrize("name", list(TABLES))
def test_table_writes_what_pandas_writes(name, tmp_path):
    rows = TABLES[name]
    Table(rows).to_csv(tmp_path / "t.csv")
    pd.DataFrame(rows).T.to_csv(tmp_path / "p.csv")
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "p.csv").read_text()
    columns = {"id": ["a", "b,c"], "v": [0.5, np.nan], "q": ["Good", "Poor"]}
    Table.from_columns(columns).to_csv(tmp_path / "t.csv")
    pd.DataFrame(columns).to_csv(tmp_path / "p.csv")
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "p.csv").read_text()


def test_runner_runs_the_processors_on_the_cpu(tmp_path, capsys):
    """The slice as a whole: runner.run(device="cpu") on data=synthetic with
    the five flagship processors writes the CSVs, .npy dicts and
    metrics.json under save_path/results and reports no processor error;
    an eval-only run with the `plotting` processor draws its panels, and
    one with an unknown processor records it in processor_errors and makes
    main exit 1."""
    overrides = ["data=synthetic", "data.image_size=64", "data.n_patients=5",
                 "task.model.kernels=[[3,3],[3,3],[3,3],[3,3]]",
                 "task.model.strides=[[1,1],[2,2],[2,2],[2,2]]", "task.t_a=4",
                 "trainer.batch_size=4", "trainer.max_epochs=1", f"save_path={tmp_path}",
                 f"task.psm_path={tmp_path / 'psm.npz'}", "seed=4",
                 "data.results_processors=[point_metrics, calibration, clinical_metrics, "
                 "instant_metrics, mutual_info]"]
    result = runner.run(overrides, device="cpu")
    assert "processor_errors" not in result
    out = tmp_path / "results"
    for name in ("instant_metrics.csv", "data_instant.npy", "data_point.npy", "metrics.json",
                 *(f"clinical/{t}_df.csv" for t in ("instant", "view", "patient", "volume"))):
        assert (out / name).exists(), name
    metrics = json.loads((out / "metrics.json").read_text())
    assert "processor_errors" not in metrics and "clinical_metrics/patient/EF_error" in metrics
    patient = pd.read_csv(out / "clinical" / "patient_df.csv", index_col=0)
    assert len(patient) == 1 and np.isfinite(patient["EF_mean"]).all()

    failing = overrides + ["train=false", "test=false",
                           "data.results_processors=[instant_metrics, plotting, nonsense]"]
    evaluated = runner.run(failing, device="cpu")
    assert set(evaluated["processor_errors"]) == {"nonsense"}
    assert sorted(p.name for p in (out / "figures").iterdir()) == [
        "patient0005_2CH.png", "patient0005_4CH.png"]
    with pytest.raises(SystemExit) as exit_info:
        runner.main(failing + ["--device=cpu"])
    assert exit_info.value.code == 1
    assert "evaluation produced errors" in capsys.readouterr().out
    runner.main(overrides + ["train=false", "--device=cpu"])  # no error: exits normally
