"""PyTorch port vs JAX package: the figures (utils/plotting.py,
results/metric_figures.py, the processors' plots, the tasks' `val_figure`,
train/logging.py `log_figure` and the trainer's figure hook).

The views come from the port's run_predict on the CPU (64^2, a 4-stage
UNet, T_e=2, T_a=4, two test patients with both views); the JAX package
gets them as its own BatchResults. Everything is drawn on Agg canvases.

Tolerances:
- pixels bitwise (decoded RGBA) where both packages draw the same numbers:
  `confidence_ellipse`, `plot_skewed_normals`, `render_view_payload` on
  one payload, the serial and the pooled dashboards, and every processor
  figure whose numbers come from the same numpy code;
- figures that plot values downstream of the clinical f32 reductions
  (GLS, EDV, ESV, EF, Volume; tests/test_torch_port_results.py holds those
  values to 1e-5 + 5e-5 * |value|) and the dashboards (which also carry
  the dense splines): at most 1% of their pixels differ;
- the dashboards' dense splines (the port solves them in f64) within
  2e-4 px (the spline's bar in tests/test_torch_port_raster.py) of JAX's
  spline evaluated in f64 on every sample, and of JAX's f32 payload where
  that is within 1e-4 px of its f64 evaluation (see
  test_prepare_view_payload_matches_jax); every other payload leaf equal;
- `val_figure`: the plotted means and ellipse centres within 1e-3 px of
  JAX's, the ellipses' axes within 1e-3 of their scale (the forward's bar
  in tests/test_torch_port_unet.py); the segmentation overlay's label map
  within 8 pixels (tests/test_torch_port_seg_predict.py's `pred` budget);
- one `Trainer.fit` epoch with `log_figures` writes the validation figure
  the JAX trainer writes for the same weights, under the same name.

Without matplotlib (`sys.modules["matplotlib"] = None`, its submodules
unloaded) every processor writes the same numbers, CSVs and .npy files as
with it, and records "ModuleNotFoundError: No module named 'matplotlib'"
under `figure_errors`.
"""

import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.image as mimage
import numpy as np
import pytest
import torch
from matplotlib import pyplot as plt

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu.data.config import DataParams as JDataParams
from contouring_uncertainty_tpu.parallel import make_mesh
from contouring_uncertainty_tpu.results import metric_figures as jfig
from contouring_uncertainty_tpu.results import run_processors as j_run
from contouring_uncertainty_tpu.ops import spline as jspline
from contouring_uncertainty_tpu.tasks import DSNTAleatoric as JDSNT
from contouring_uncertainty_tpu.tasks.dsnt_skew import DSNTSkew as JSkew
from contouring_uncertainty_tpu.tasks import segmentation as jseg
from contouring_uncertainty_tpu.train import Trainer as JTrainer
from contouring_uncertainty_tpu.train import TrainerConfig as JTrainerConfig
from contouring_uncertainty_tpu.utils import plotting as jplot
from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch.convert import flax_to_torch_state
from contouring_uncertainty_torch.data.config import DataParams
from contouring_uncertainty_torch.data.synthetic import make_arrays, synthetic_camus_data
from contouring_uncertainty_torch.results import metric_figures as tfig
from contouring_uncertainty_torch.results import point_metrics, run_processors
from contouring_uncertainty_torch.tasks import DSNTAleatoric, DSNTSkew
from contouring_uncertainty_torch.tasks import segmentation as tseg
from contouring_uncertainty_torch.train import Trainer, TrainerConfig
from contouring_uncertainty_torch.utils import plotting as tplot
from test_torch_port_results import to_jax
from test_torch_port_segmentation import make_pair
from test_torch_port_skew_model import torch_to_flax_params

torch.set_num_threads(1)

SMALL = dict(kernels=((3, 3),) * 4, strides=((1, 1),) + ((2, 2),) * 3, drop_block=True)
FIGURE_PROCESSORS = ["point_metrics", "instant_metrics", "clinical_metrics", "skewness",
                     "plotting"]
MISSING = "ModuleNotFoundError: No module named 'matplotlib'"
# The files each processor writes, by path under out_dir.
OWN = {
    "point_metrics": lambda p: p == "data_point.npy" or p.endswith(("_point.png", "_points.png"))
    or p.startswith("corr_thresholds-"),
    "instant_metrics": lambda p: p in ("instant_metrics.csv", "data_instant.npy",
                                       "correlation_instant.png"),
    "clinical_metrics": lambda p: p.startswith("clinical/"),
    "skewness": lambda p: p.startswith("skewness"),
    "plotting": lambda p: p.startswith("figures/"),
}
DEVICE_REDUCED = ("GLS", "EDV", "ESV", "EF", "Volume", "metric_figures")
SPLINE_BAR_PX = 2e-4


def _files(root: Path):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())


def _pixels(path) -> np.ndarray:
    return mimage.imread(path)


def _canvas(fig) -> np.ndarray:
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def _hide_matplotlib(mp):
    """Make every import of matplotlib fail as it does where it is not
    installed (sys.modules["matplotlib"] = None, its submodules unloaded)."""
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        mp.delitem(sys.modules, name)
    mp.setitem(sys.modules, "matplotlib", None)


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    data = synthetic_camus_data(n_patients=6, size=64, seed=1)
    task = DSNTAleatoric(data_params=data.data_params, t_e=2, t_a=4, model_kwargs=SMALL)
    model = task.build_model(device="cpu", generator=torch.Generator().manual_seed(0))
    cfg = {"seed": 3, "task": {"psm_path": str(tmp_path_factory.mktemp("prior") / "p.npz")}}
    results = tpred.run_predict(task, model, data, cfg, device="cpu")
    assert len(results) == 4 and {r.id.rpartition("/")[2] for r in results} == {"2CH", "4CH"}
    return results


@pytest.fixture(scope="module")
def runs(views, tmp_path_factory):
    """The five processors that draw: the port with matplotlib (its
    dashboards' payload arguments recorded), the port without it, and the
    JAX package (drawing), each into its own directory."""
    cfg = {"data": {"results_processors": FIGURE_PROCESSORS}}
    root = tmp_path_factory.mktemp("figures")
    calls, hidden_calls = [], []
    prepare = tfig.prepare_view_payload
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfig, "prepare_view_payload",
                   lambda *args: calls.append(args) or prepare(*args))
        port = run_processors(views, root / "port", cfg, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        _hide_matplotlib(mp)
        mp.setattr(tfig, "prepare_view_payload",
                   lambda *args: hidden_calls.append(args) or prepare(*args))
        hidden = run_processors(views, root / "hidden", cfg, device="cpu")
    ref = j_run([to_jax(v) for v in views], root / "jax", cfg)
    return {"port": port, "hidden": hidden, "jax": ref, "root": root, "calls": calls,
            "hidden_calls": hidden_calls}


# ------------------------------------------------------------ utils/plotting
COVARIANCES = {
    "isotropic": np.eye(2) * 9.0,
    "rotated": np.array([[30.0, 12.0], [12.0, 8.0]]),
    "near_singular": np.array([[16.0, 15.999], [15.999, 16.0]]),
}


@pytest.mark.parametrize("name", list(COVARIANCES))
def test_confidence_ellipse_pixels_match_jax(name):
    """The 2-sigma ellipse of each covariance, with and without keyword
    styling, on same-sized canvases: RGBA bitwise equal."""
    pixels = []
    for module in (jplot, tplot):
        fig, ax = plt.subplots(figsize=(3, 3), dpi=80)
        ax.set_xlim(0, 64)
        ax.set_ylim(64, 0)
        module.confidence_ellipse(30.0, 25.0, COVARIANCES[name], ax, n_std=2)
        module.confidence_ellipse(40.0, 40.0, COVARIANCES[name], ax, n_std=1.0,
                                  edgecolor="orange", alpha=0.6)
        pixels.append(_canvas(fig))
        plt.close(fig)
    assert (pixels[0] != 255).any()
    np.testing.assert_array_equal(pixels[1], pixels[0])


@pytest.mark.parametrize("flip_y", [True, False])
def test_plot_skewed_normals_pixels_match_jax(flip_y):
    """Skew-normal level contours of five landmarks (the port's density in
    torch, JAX's in jax.numpy, both f32): RGBA bitwise equal."""
    rng = np.random.default_rng(0)
    mu = rng.uniform(15, 50, (5, 2))
    a = rng.normal(size=(5, 2, 2))
    cov = a @ a.transpose(0, 2, 1) * 4 + np.eye(2)
    alpha = rng.normal(size=(5, 2)) * 3
    pixels = []
    for module in (jplot, tplot):
        fig, ax = plt.subplots(figsize=(3, 3), dpi=80)
        ax.set_xlim(0, 64)
        ax.set_ylim(64, 0)
        module.plot_skewed_normals(ax, mu, cov, alpha, flip_y=flip_y)
        pixels.append(_canvas(fig))
        plt.close(fig)
    assert (pixels[0] != 255).any()
    np.testing.assert_array_equal(pixels[1], pixels[0])


# ------------------------------------------------------------ metric_figures
def _same_payload(got, ref, path=""):
    """Nested payloads equal leaf by leaf (NaN matching NaN)."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _same_payload(got[k], ref[k], f"{path}/{k}")
    elif ref is None or isinstance(ref, (str, bool)):
        assert got == ref, path
    else:
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == ref.dtype, path
        np.testing.assert_array_equal(got, ref, err_msg=path)


@pytest.mark.parametrize("i", range(4))
def test_prepare_view_payload_matches_jax(runs, i):
    """The payload of each view from the clinical processor's rows and MC
    populations: the port on the CPU against JAX's from the same
    BatchResult. The images, masks and metric infos equal. The dense
    splines (2 x 4 samples an instant, 256 points; the port solves them
    in f64) finite and within 2e-4 px of JAX's spline evaluated in f64 at
    the same f32 parameter grid on every sample. JAX's payload solves in f32, which this untrained
    model's samples with sub-pixel segments move up to 5e-3 px from f64:
    the port is held to it within 2e-4 px on the samples where it lies
    within 1e-4 px of its f64 evaluation, at least half of them."""
    res, instant_rows, view_rows, mc, device = runs["calls"][i]
    assert device == torch.device("cpu")
    got = tfig.prepare_view_payload(res, instant_rows, view_rows, mc, "cpu")
    ref = jfig.prepare_view_payload(to_jax(res), instant_rows, view_rows, mc)
    for name, frame in res.instants.items():
        g = got["panels"][name].pop("dense_samples")
        r = ref["panels"][name].pop("dense_samples")
        assert g.shape == r.shape == (8, 256, 2) and g.dtype == r.dtype == np.float32
        assert np.isfinite(g).all()
        samples = res.contour_samples[frame][:2, :5].reshape(-1, 21, 2)
        with jax.enable_x64(True):
            # Both payloads evaluate at the f32 parameter grid.
            t = jnp.linspace(0.0, 1.0, 256, dtype=jnp.float32).astype(jnp.float64)
            f64 = np.asarray(jax.vmap(lambda q: jspline.spline_eval(*jspline.spline_fit(q), t))(
                jnp.asarray(samples, dtype=jnp.float64)))
        assert f64.dtype == np.float64
        assert np.abs(g - f64).max() <= SPLINE_BAR_PX
        steady = np.abs(r - f64).max(axis=(1, 2)) <= 1e-4
        assert steady.mean() >= 0.5
        assert np.abs(g - r)[steady].max() <= SPLINE_BAR_PX
    assert got["panels"]["ES"]["sample_masks"].shape == (8, 64, 64)
    _same_payload(got, ref)


@pytest.mark.parametrize("reject", [False, True], ids=["kept", "rejected"])
@pytest.mark.parametrize("use_contour", [True, False], ids=["splines", "masks"])
def test_render_view_payload_pixels_match_jax(runs, tmp_path, use_contour, reject):
    """One identical payload (JAX's, every metric's reject flag set as
    asked) drawn by both packages: the same file name ({id}.png or
    {id}_reject.png) and RGBA bitwise equal."""
    res, instant_rows, view_rows, mc, _ = runs["calls"][0]
    payload = jfig.prepare_view_payload(to_jax(res), instant_rows, view_rows, mc)
    for info in payload["metric_infos"].values():
        if info is not None:
            info["reject"] = reject
    got = tfig.render_view_payload(payload, tmp_path / "port", use_contour=use_contour)
    ref = jfig.render_view_payload(payload, tmp_path / "jax", use_contour=use_contour)
    assert got.name == ref.name and got.name.endswith("_reject.png") == reject
    np.testing.assert_array_equal(_pixels(got), _pixels(ref))


def test_render_dashboards_pool_matches_serial(runs, tmp_path, monkeypatch):
    """Two views' dashboards rendered through the fork pool
    (parallel_threshold lowered to 2) from the payloads the clinical
    processor prepared: the pool renders every figure in its workers (none
    in this process) and writes the files of the processor's serial run,
    bitwise."""
    payloads = [tfig.prepare_view_payload(*args[:4], "cpu") for args in runs["calls"][:2]]
    in_parent = []
    render = tfig.render_view_payload
    monkeypatch.setattr(tfig, "render_view_payload",
                        lambda *a, **k: in_parent.append(a) or render(*a, **k))
    tfig.render_dashboards(payloads, tmp_path, parallel_threshold=2, max_workers=2)
    assert in_parent == []
    files = _files(tmp_path)
    stems = [args[0].id.replace("/", "-") for args in runs["calls"][:2]]
    assert len(files) == 4 and all(any(stem in f for stem in stems) for f in files)
    for name in files:
        np.testing.assert_array_equal(_pixels(tmp_path / name),
                                      _pixels(runs["root"] / "port" / "clinical" / name))


def test_render_dashboards_prints_a_pool_failure_and_renders_serially(runs, tmp_path,
                                                                      monkeypatch, capsys):
    """A pool that cannot start (here: no fork context) is printed to
    stderr with its exception, and the dashboards are rendered serially in
    this process into the files of the processor's run, bitwise."""
    import multiprocessing

    def no_fork(method=None):
        raise ValueError(f"cannot find context for {method!r}")

    monkeypatch.setattr(multiprocessing, "get_context", no_fork)
    payloads = [tfig.prepare_view_payload(*runs["calls"][0][:4], "cpu")]
    tfig.render_dashboards(payloads, tmp_path, parallel_threshold=1)
    err = capsys.readouterr().err
    assert "the fork pool failed (ValueError: cannot find context for 'fork')" in err
    files = _files(tmp_path)
    assert len(files) == 2
    for name in files:
        np.testing.assert_array_equal(_pixels(tmp_path / name),
                                      _pixels(runs["root"] / "port" / "clinical" / name))


# ------------------------------------------------------------ processors
@pytest.mark.parametrize("name", FIGURE_PROCESSORS)
def test_processor_figures_match_jax(runs, name):
    """Each processor that draws writes the JAX package's file names for the
    same views; each figure's pixels equal JAX's bitwise, or within 1% of
    its pixels where it plots values of the clinical f32 reductions."""
    assert "figure_errors" not in runs["port"] and "processor_errors" not in runs["port"]
    port = [p for p in _files(runs["root"] / "port") if OWN[name](p)]
    ref = [p for p in _files(runs["root"] / "jax") if OWN[name](p)]
    assert port == ref
    pngs = [p for p in port if p.endswith(".png")]
    assert pngs
    for png in pngs:
        got, want = _pixels(runs["root"] / "port" / png), _pixels(runs["root"] / "jax" / png)
        assert got.shape == want.shape, png
        if any(m in png for m in DEVICE_REDUCED):
            assert (got != want).any(axis=-1).mean() <= 0.01, png
        else:
            np.testing.assert_array_equal(got, want, err_msg=png)


def _helper_inputs():
    """Uncertainties and errors of 300 samples (one of them NaN), and the
    clinical rows of 12 views, made from a seed."""
    rng = np.random.default_rng(5)
    u = {k: rng.gamma(2.0, 1.5, 300) for k in ("cov_xx", "cov_yy", "cov_det")}
    m = {k: u[c] * rng.uniform(0.5, 1.5, 300) + rng.normal(0, 0.5, 300)
         for k, c in (("X-Error", "cov_xx"), ("Y-Error", "cov_yy"), ("Error", "cov_det"))}
    m["Error"][7] = np.nan
    rows = {}
    for i in range(12):
        gt = rng.uniform(500, 900)
        std = rng.uniform(5, 40)
        rows[f"patient{i:04d}/2CH/ED"] = {
            "Area_pred": gt + rng.normal(0, 30), "Area_gt": gt, "Area_error": abs(rng.normal(0, std)),
            "Area_std": std, "Area_mean": gt + rng.normal(0, 20), "Area_reject": i == 3}
    return u, m, rows


def _jax_helper(name, root):
    import pandas as pd

    from contouring_uncertainty_tpu.results import clinical as jclinical
    from contouring_uncertainty_tpu.results import utils as jutils

    u, m, rows = _helper_inputs()
    keys = (["cov_xx", "cov_yy", "cov_det"], ["X-Error", "Y-Error", "Error"])
    if name == "calibration":
        return jutils.calibration(u, m, *keys, filename=root / "c.png", adaptive=True)
    if name == "thresholded_metrics":
        return jutils.thresholded_metrics(u, m, *keys, filename=root / "t.png")
    if name == "thresholded_correlation":
        return jutils.thresholded_correlation(u, m, "cov_det", "Error", out_dir=root)
    if name == "compute_correlations":
        df = jutils.compute_correlations(u, m, title="T", ids=list(range(300)),
                                         filename=root / "r.png")
        return {f"{a}-{b}": df.loc[a, b] for a in df.index for b in df.columns}
    summary = {}
    df = pd.DataFrame(rows).T
    if name == "plot_metric_calibration":
        jclinical.plot_metric_calibration(df, "Area", root, summary)
    else:
        jclinical.plot_metric_correlation(df, "Area", root)
    return summary


def _port_helper(name, root):
    from contouring_uncertainty_torch.results import clinical, utils

    u, m, rows = _helper_inputs()
    keys = (["cov_xx", "cov_yy", "cov_det"], ["X-Error", "Y-Error", "Error"])
    if name == "calibration":
        return utils.calibration(u, m, *keys, filename=root / "c.png", adaptive=True)
    if name == "thresholded_metrics":
        return utils.thresholded_metrics(u, m, *keys, filename=root / "t.png")
    if name == "thresholded_correlation":
        return utils.thresholded_correlation(u, m, "cov_det", "Error", out_dir=root)
    if name == "compute_correlations":
        df = utils.compute_correlations(u, m, title="T", ids=list(range(300)),
                                        filename=root / "r.png")
        return {f"{a}-{b}": df.loc(a, b) for a in df.index for b in df.columns}
    summary = {}
    if name == "plot_metric_calibration":
        clinical.plot_metric_calibration(utils.Table(rows), "Area", root, summary)
    else:
        clinical.plot_metric_correlation(utils.Table(rows), "Area", root)
    return summary


HELPERS = ["calibration", "thresholded_metrics", "thresholded_correlation",
           "compute_correlations", "plot_metric_calibration", "plot_metric_correlation"]


@pytest.mark.parametrize("name", HELPERS)
def test_figure_helpers_match_jax(tmp_path, name):
    """Each figure-drawing helper of results/utils.py and results/clinical.py
    called as the JAX package's is, with its `filename` / `out_dir`, on
    the same numbers: the same returned numbers, the same file name, RGBA
    bitwise equal."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _port_helper(name, tmp_path / "port")
    ref = _jax_helper(name, tmp_path / "jax")
    assert set(got) == set(ref)
    for key in ref:
        _same_value(got[key], ref[key], key)
    files = _files(tmp_path / "jax")
    assert len(files) == 1 and _files(tmp_path / "port") == files
    np.testing.assert_array_equal(_pixels(tmp_path / "port" / files[0]),
                                  _pixels(tmp_path / "jax" / files[0]))


def test_metric_plot_matches_jax(runs, tmp_path):
    """metric_plot (payload and render of one view in one call) writes
    JAX's file for the same view and rows, its pixels within 1% of JAX's
    (the dense splines)."""
    res, instant_rows, view_rows, mc, _ = runs["calls"][0]
    got = tfig.metric_plot(res, instant_rows, view_rows, mc, tmp_path / "port", device="cpu")
    ref = jfig.metric_plot(to_jax(res), instant_rows, view_rows, mc, tmp_path / "jax")
    assert got.name == ref.name
    a, b = _pixels(got), _pixels(ref)
    assert a.shape == b.shape and (a != b).any(axis=-1).mean() <= 0.01


def _same_value(got, ref, key):
    if isinstance(ref, float) and np.isnan(ref):
        assert np.isnan(got), key
    else:
        assert got == ref, key


@pytest.mark.parametrize("name", FIGURE_PROCESSORS)
def test_missing_matplotlib_keeps_the_numbers(runs, name):
    """Without matplotlib each processor that draws writes the numbers,
    CSVs and .npy files it writes with matplotlib, draws no PNG, and is
    named under figure_errors (matplotlib only), not processor_errors;
    the clinical dashboards record their own error."""
    hidden, port, root = runs["hidden"], runs["port"], runs["root"]
    assert hidden["figure_errors"] == {n: MISSING for n in FIGURE_PROCESSORS}
    assert "processor_errors" not in hidden
    keys = sorted(k for k in port if k.startswith(name + "/"))
    extra = {k for k in hidden if k.startswith(name + "/")} - set(keys)
    if name == "clinical_metrics":
        assert extra == {"clinical_metrics/metric_figures_error"}
        assert runs["hidden_calls"] == []  # no payload (no spline launch) without matplotlib
        assert "No module named 'matplotlib'" in hidden["clinical_metrics/metric_figures_error"] \
            or "matplotlib" in hidden["clinical_metrics/metric_figures_error"]
    else:
        assert extra == set()
    for key in keys:
        _same_value(hidden[key], port[key], key)
    files = [p for p in _files(root / "port") if OWN[name](p)]
    data = [p for p in files if not p.endswith(".png")]
    assert [p for p in _files(root / "hidden") if OWN[name](p)] == data
    for path in data:
        assert (root / "hidden" / path).read_bytes() == (root / "port" / path).read_bytes(), path


@pytest.mark.parametrize("error", [RuntimeError("boom"),
                                   ModuleNotFoundError("No module named 'PIL'", name="PIL")],
                         ids=["runtime_error", "other_module"])
def test_other_figure_failures_fail_the_processor(views, tmp_path, monkeypatch, error):
    """Any figure failure but a missing matplotlib fails its processor into
    processor_errors, as in the JAX package; the others still run."""
    def fail(*args, **kwargs):
        raise error

    monkeypatch.setattr(point_metrics, "_plot_corr", fail)
    got = run_processors(views, tmp_path, {"data": {"results_processors": [
        "point_metrics", "sigma_stats"]}}, device="cpu")
    assert got["processor_errors"] == {"point_metrics": f"{type(error).__name__}: {error}"}
    assert "figure_errors" not in got and "sigma_stats/avg_distance" in got


# ------------------------------------------------------------ val_figure
def _val_pair(kind):
    """(JAX task, flax model, variables, port task, port model, numpy batch)
    with the same weights."""
    img, gt, contour = make_arrays(4, size=64, seed=3)
    batch = {"img": img, "gt": gt.astype(np.int32), "contour": contour}
    if kind == "mcdropout":
        return (*make_pair(jseg.McDropoutUncertainty, tseg.McDropoutUncertainty, 1,
                           SMALL), batch)
    dp = dict(in_shape=(1, 64, 64), out_shape=(21, 2))
    jcls, tcls = (JSkew, DSNTSkew) if kind == "dsnt-skew" else (JDSNT, DSNTAleatoric)
    jtask = jcls(data_params=JDataParams(**dp), t_e=1, model_kwargs=dict(SMALL))
    task = tcls(data_params=DataParams(**dp), t_e=1, model_kwargs=dict(SMALL))
    jmodel = jtask.build_model()
    model = task.build_model(device="cpu", generator=torch.Generator().manual_seed(4))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.asarray(img))
    params = torch_to_flax_params(model.state_dict(), shapes)
    assert set(flax_to_torch_state(params)) == set(model.state_dict())
    return jtask, jmodel, {"params": jax.tree.map(jnp.asarray, params)}, task, model, batch


def _ellipse_points(patch):
    """The centre and the two axis ends of an ellipse, in data coordinates."""
    to_data = patch.get_transform() - patch.axes.transData
    return to_data.transform([(0.0, 0.0), (1.0, 0.0), (0.0, 1.0)])


@pytest.mark.parametrize("kind", ["dsnt-al", "dsnt-skew", "mcdropout"])
def test_val_figure_matches_jax(kind):
    """val_figure on the same weights and batch: the same panels; the
    contour tasks' reference and predicted points and ellipses at JAX's
    (1e-3 px, axes within 1e-3 of their scale), the segmentation overlay's
    label map within 8 pixels and the reference image equal."""
    jtask, jmodel, variables, task, model, batch = _val_pair(kind)
    ref = jtask.val_figure(jmodel, variables, batch)
    got = task.val_figure(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    try:
        assert len(got.axes) == len(ref.axes) == 4
        for ax, jax_ax in zip(got.axes, ref.axes):
            np.testing.assert_array_equal(ax.images[0].get_array(), jax_ax.images[0].get_array())
            if kind == "mcdropout":
                diff = ax.images[1].get_array() != jax_ax.images[1].get_array()
                assert diff.sum() <= 8
                assert len(ax.collections) == len(jax_ax.collections) == 1
                continue
            assert len(ax.collections) == len(jax_ax.collections) == 2
            np.testing.assert_array_equal(ax.collections[0].get_offsets(),
                                          jax_ax.collections[0].get_offsets())
            np.testing.assert_allclose(ax.collections[1].get_offsets(),
                                       jax_ax.collections[1].get_offsets(), rtol=0, atol=1e-3)
            assert len(ax.patches) == len(jax_ax.patches) == 21
            for patch, jax_patch in zip(ax.patches, jax_ax.patches):
                p, q = _ellipse_points(patch), _ellipse_points(jax_patch)
                np.testing.assert_allclose(p[0], q[0], rtol=0, atol=1e-3)
                scale = np.abs(q[1:] - q[0]).max()
                np.testing.assert_allclose(p[1:] - p[0], q[1:] - q[0], rtol=0,
                                           atol=1e-3 * scale)
    finally:
        plt.close(got)
        plt.close(ref)


def test_val_figure_without_matplotlib_runs_no_forward(monkeypatch):
    """Without matplotlib val_figure raises ModuleNotFoundError before its
    forward: the model is never called."""
    dp = DataParams(in_shape=(1, 64, 64), out_shape=(21, 2))
    task = DSNTAleatoric(data_params=dp, model_kwargs=dict(SMALL))
    model = task.build_model(device="cpu")
    calls = []
    monkeypatch.setattr(type(model), "forward", lambda *a, **k: calls.append(a))
    _hide_matplotlib(monkeypatch)
    with pytest.raises(ModuleNotFoundError) as info:
        task.val_figure(model, {"img": torch.zeros(2, 1, 64, 64)})
    assert info.value.name == "matplotlib" and calls == []


def test_fit_logs_the_validation_figure_as_jax_does(tmp_path, monkeypatch):
    """One epoch of each package's fit on the same weights of a 2-stage
    UNet (their steps replaced by stand-ins, so only the figure hook runs
    the model; two validation images): both
    write figures/val_contours_0.png in the run directory, with the same
    panels; log_figures=False writes none."""
    img, gt, contour = make_arrays(6, size=64, seed=1)
    arrays = {"img": img, "gt": gt.astype(np.int32), "contour": contour}
    train, val = arrays, {k: v[:2] for k, v in arrays.items()}
    tiny = dict(kernels=((3, 3),) * 2, strides=((1, 1), (2, 2)))
    common = dict(batch_size=4, max_epochs=1, seed=3, fast_dev_run=1, save_every=0,
                  name="fig")
    dp = dict(in_shape=(1, 64, 64), out_shape=(21, 2))

    def jax_steps(self):
        self._train_step = lambda state, batch, rng, step: (state, {"loss": jnp.float32(1.0)})
        self._eval_step = lambda state, batch: {"loss": jnp.float32(1.0)}

    monkeypatch.setattr(JTrainer, "_build_steps", jax_steps)
    jtrainer = JTrainer(JDSNT(data_params=JDataParams(**dp), model_kwargs=dict(tiny)),
                        JTrainerConfig(save_path=str(tmp_path / "jax"), **common),
                        mesh=make_mesh(1))
    params = {}
    original = jtrainer.init_state

    def init_state(*args, **kwargs):
        state = original(*args, **kwargs)
        params.update(flax_to_torch_state(jax.tree.map(np.asarray, state.params)))
        return state

    monkeypatch.setattr(jtrainer, "init_state", init_state)
    jtrainer.fit(train, val)

    monkeypatch.setattr(Trainer, "train_step",
                        lambda self, batch, step: {"loss": torch.tensor(1.0)})
    monkeypatch.setattr(Trainer, "eval_step", lambda self, batch: {"loss": torch.tensor(1.0)})
    task = DSNTAleatoric(data_params=DataParams(**dp), model_kwargs=dict(tiny))
    for log_figures in (True, False):
        trainer = Trainer(task, TrainerConfig(save_path=str(tmp_path / f"port{log_figures}"),
                                              log_figures=log_figures, **common),
                          device="cpu")
        trainer.init_state = lambda: (Trainer.init_state(trainer),
                                      trainer.model.load_state_dict(params))
        trainer.fit(train, val)
    got = sorted(p.name for p in (tmp_path / "portTrue" / "3" / "figures").iterdir())
    ref = sorted(p.name for p in (tmp_path / "jax" / "3" / "figures").iterdir())
    assert got == ref == ["val_contours_0.png"]
    a, b = (plt.imread(tmp_path / side / "3" / "figures" / "val_contours_0.png")
            for side in ("portTrue", "jax"))
    assert a.shape == b.shape == (240, 480, 4)
    assert not (tmp_path / "portFalse" / "3" / "figures").exists()
