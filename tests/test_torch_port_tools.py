"""PyTorch port vs JAX package: the offline tools (tools.py,
data/generators.py, sampler/naive.py).

The raw CAMUS and JSRT trees are written by the tests (MetaImage files,
info files, fold lists; raw big-endian scans and landmark files), as the
JAX package's tests/test_generators.py writes them, and both packages'
generators turn the same tree into HDF5 files whose contents are compared.
"""

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contouring_uncertainty_tpu import tools as jtools
from contouring_uncertainty_tpu.data import generators as jgen
from contouring_uncertainty_tpu.sampler.naive import NaiveSampler as JNaive
from contouring_uncertainty_torch import predict as tpred
from contouring_uncertainty_torch import tools
from contouring_uncertainty_torch.config import compose
from contouring_uncertainty_torch.data import generators as gen
from contouring_uncertainty_torch.data.lung import N_POINTS
from contouring_uncertainty_torch.data.synthetic import make_sample, write_camus_hdf5
from contouring_uncertainty_torch.factory import build_data
from contouring_uncertainty_torch.sampler.naive import NaiveSampler
from contouring_uncertainty_torch.sampler.prior import ShapePrior

torch.set_num_threads(1)


@pytest.mark.parametrize("element_type", ["MET_UCHAR", "MET_USHORT", "MET_FLOAT"])
@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "zraw"])
def test_mhd_round_trip_matches_jax(tmp_path, element_type, compressed):
    """write_mhd and read_mhd of each package read what the other wrote: the
    same header and data bytes, the array and the spacing back exactly."""
    rng = np.random.default_rng(0)
    arr = (rng.integers(0, 255, (3, 16, 20)) if element_type != "MET_FLOAT"
           else rng.normal(size=(3, 16, 20)))
    paths = {}
    for name, mod in (("torch", gen), ("jax", jgen)):
        paths[name] = tmp_path / name / "x.mhd"
        paths[name].parent.mkdir()
        mod.write_mhd(paths[name], arr, spacing=(0.5, 0.7, 1.0), element_type=element_type,
                      compressed=compressed)
    assert paths["torch"].read_text() == paths["jax"].read_text()
    data = "x.zraw" if compressed else "x.raw"
    assert (tmp_path / "torch" / data).read_bytes() == (tmp_path / "jax" / data).read_bytes()
    for reader in (gen.read_mhd, jgen.read_mhd):
        for path in paths.values():
            back, spacing = reader(path)
            np.testing.assert_array_equal(back, arr.astype(back.dtype))
            assert spacing == (0.5, 0.7, 1.0)


def _raw_camus(root, n_frames=5, size=128, es_first=()):
    """The raw CAMUS layout: two patients, fold lists for folds 1 and 5,
    half-cycle sequences of synthetic LV frames and their masks, info
    files (the views in `es_first` put ES before ED)."""
    patients = ("patient0001", "patient0002")
    (root / "listSubGroups").mkdir(parents=True)
    for fold in (1, 5):
        for subset, pats in (("training", patients[:1]), ("validation", patients[1:]),
                             ("testing", patients[1:])):
            (root / "listSubGroups" / f"subGroup{fold}_{subset}.txt").write_text(
                "\n".join(pats) + "\n")
    rng = np.random.default_rng(3)
    for pid in patients:
        pdir = root / pid
        pdir.mkdir()
        for view in ("2CH", "4CH"):
            imgs, gts = [], []
            for _ in range(n_frames):
                img, gt, _ = make_sample(rng, size=size)
                imgs.append((img * 255).astype(np.uint8))
                gts.append(gt.astype(np.uint8))
            gen.write_mhd(pdir / f"{pid}_{view}_half_sequence.mhd", np.stack(imgs),
                          spacing=(0.31, 0.15, 1.0))
            gen.write_mhd(pdir / f"{pid}_{view}_half_sequence_gt.mhd", np.stack(gts),
                          spacing=(0.31, 0.15, 1.0))
            ed, es = (n_frames, 1) if (pid, view) in es_first else (1, n_frames)
            quality = "ImageQuality: Good\n" if view == "2CH" else ""
            (pdir / f"Info_{view}.cfg").write_text(
                f"ED: {ed}\nES: {es}\nNbFrame: {n_frames}\n{quality}")


def _h5_contents(path):
    """Every dataset (array) and attribute of an HDF5 file, by path."""
    out = {}

    def visit(name, obj):
        for key, value in obj.attrs.items():
            out[f"{name}@{key}"] = np.asarray(value)
        if isinstance(obj, h5py.Dataset):
            out[name] = (obj[()], obj.dtype, obj.compression)

    with h5py.File(path, "r") as f:
        for key, value in f.attrs.items():
            out[f"@{key}"] = np.asarray(value)
        f.visititems(visit)
    return out


def _assert_same_h5(got, ref):
    a, b = _h5_contents(got), _h5_contents(ref)
    assert sorted(a) == sorted(b)
    for key in a:
        if isinstance(a[key], tuple):
            assert a[key][1:] == b[key][1:], key
            np.testing.assert_array_equal(a[key][0], b[key][0], err_msg=key)
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    return a


@pytest.mark.parametrize("sequence", [False, True], ids=["ed_es", "sequence"])
def test_generate_camus_matches_jax(tmp_path, sequence):
    """generate_camus of both packages on one raw tree (patient0002's 4CH
    view with ES before ED) writes the same HDF5 file: datasets (img_proc,
    gt, gt_proc), dtypes, compression and attributes. The reversed view is
    in ED -> ES order, with or without `sequence`."""
    raw = tmp_path / "raw"
    _raw_camus(raw, es_first={("patient0002", "4CH")})
    out, ref = tmp_path / "torch.h5", tmp_path / "jax.h5"
    gen.generate_camus(raw, out, folds=(1, 5), target_image_size=(64, 64), sequence=sequence)
    jgen.generate_camus(raw, ref, folds=(1, 5), target_image_size=(64, 64), sequence=sequence)
    contents = _assert_same_h5(out, ref)
    assert contents["patient0001/2CH@ImageQuality"] == "Good"
    frames = 5 if sequence else 2
    assert contents["patient0002/4CH/img_proc"][0].shape == (frames, 64, 64, 1)
    assert int(contents["patient0002/4CH@ED"]) == 0
    assert int(contents["patient0002/4CH@ES"]) == frames - 1
    # The ES-first sequence is reversed: its last raw frame (ED) comes first.
    seq, _ = gen.read_mhd(raw / "patient0002" / "patient0002_4CH_half_sequence_gt.mhd")
    np.testing.assert_array_equal(contents["patient0002/4CH/gt"][0][0], seq[-1])


def _raw_jsrt(root, ids=("JPCLN001", "JPCLN002")):
    rng = np.random.default_rng(5)
    (root / "All247images").mkdir(parents=True)
    for split, cap, split_ids in (("train", "Train", ids), ("val", "Val", ids[:1]),
                                  ("test", "Test", ids[1:])):
        (root / f"{split}_files.txt").write_text("\n".join(f"{i}.IMG" for i in split_ids) + "\n")
        landmarks = root / cap / "landmarks"
        landmarks.mkdir(parents=True, exist_ok=True)
        for i in split_ids:
            t = np.linspace(0, 2 * np.pi, N_POINTS, endpoint=False)
            pts = np.stack([512 + 250 * np.cos(t), 512 + 300 * np.sin(t)], -1)
            np.save(landmarks / f"{i}.npy", pts + rng.normal(0, 4, pts.shape))
    for i in ids:
        scan = rng.integers(0, 4096, (2048, 2048)).astype(">u2")
        (root / "All247images" / f"{i}.IMG").write_bytes(scan.tobytes())


def test_generate_jsrt_matches_jax(tmp_path):
    """generate_jsrt of both packages on one raw tree writes the same HDF5
    file (the bicubic resizes, the landmarks rescaled to 256^2, the label
    map rasterized from them)."""
    raw = tmp_path / "hybridnet-jsrt"
    _raw_jsrt(raw)
    gen.generate_jsrt(raw, tmp_path / "torch.h5")
    jgen.generate_jsrt(raw, tmp_path / "jax.h5")
    contents = _assert_same_h5(tmp_path / "torch.h5", tmp_path / "jax.h5")
    gt = contents["train/JPCLN001/gt"][0]
    assert gt.shape == (256, 256) and set(np.unique(gt)) <= {0, 1, 2} and gt.any()


def test_generate_psm_matches_jax_and_is_loaded_not_refit(tmp_path, capsys, monkeypatch):
    """generate-psm of both packages on one CAMUS file: the prior arrays
    within 1e-6 (both fit in f64 and store f32; the factor q up to its
    columns' signs, as q q^T within 1e-6 of cov0's scale), the sequence
    prior of `seq_out` too; the port's files carry the digest of the contours they
    were fit on, so the runner's get_or_fit_prior and
    get_or_fit_sequence_prior load them without refitting."""
    path = write_camus_hdf5(tmp_path / "camus.h5", n_patients=5, size=64, seed=1)
    args = ["data=camus-cont", f"data.dataset_path={path}"]
    tools.main(["generate-psm", *args, f"out={tmp_path / 't.npz'}",
                f"seq_out={tmp_path / 't_seq.npz'}"])
    jtools.generate_psm([*args, f"out={tmp_path / 'j.npz'}", f"seq_out={tmp_path / 'j_seq.npz'}"])
    assert "single-instant prior (42-dim" in capsys.readouterr().out
    for ours, theirs in (("t.npz", "j.npz"), ("t_seq.npz", "j_seq.npz")):
        with np.load(tmp_path / ours) as got, np.load(tmp_path / theirs) as ref:
            assert set(got.files) == set(ref.files) | {"fit_digest"}
            for key in ShapePrior._fields:
                if key != "q":
                    np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-6,
                                               err_msg=key)
            # q's columns are eigenvectors: each is defined up to its sign.
            q, jq = (np.asarray(f["q"], np.float64) for f in (got, ref))
            scale = float(np.abs(ref["cov0"]).max())
            np.testing.assert_allclose(q @ q.T, jq @ jq.T, rtol=0, atol=1e-6 * scale)

    def refit(*args, **kwargs):
        raise AssertionError("the prior written by generate-psm was refit")

    monkeypatch.setattr(tpred, "fit_shape_prior", refit)
    data = build_data(compose(args))
    tpred.get_or_fit_prior(data, str(tmp_path / "t.npz"))
    tpred.get_or_fit_sequence_prior(data, str(tmp_path / "t_seq.npz"))
    with pytest.raises(SystemExit):
        tools.main([])


@pytest.mark.parametrize("skew", [False, True], ids=["normal", "skew"])
def test_naive_sampler_matches_jax_in_distribution(skew):
    """NaiveSampler draws each landmark from its own (skew-)normal: 20,000
    draws of each package have the same mean and covariance per landmark
    (within 0.05 of the largest standard deviation; the draws come from
    different RNG streams), and with `sample_indices` the other landmarks
    are exactly their means."""
    rng = np.random.default_rng(0)
    k = 4
    mu = rng.uniform(10, 50, (k, 2)).astype(np.float32)
    a = rng.normal(size=(k, 2, 2))
    cov = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(2)).astype(np.float32)
    alpha = rng.normal(scale=3.0, size=(k, 2)).astype(np.float32) if skew else None
    n = 20000
    ref = np.asarray(JNaive()(jax.random.key(1), jnp.asarray(mu), jnp.asarray(cov),
                              None if alpha is None else jnp.asarray(alpha), n=n))
    got = NaiveSampler()(torch.Generator().manual_seed(1), torch.as_tensor(mu),
                         torch.as_tensor(cov), None if alpha is None else torch.as_tensor(alpha),
                         n=n).numpy()
    assert got.shape == ref.shape == (n, k, 2)
    tol = 0.05 * float(np.sqrt(np.linalg.eigvalsh(cov.astype(np.float64)).max()))
    np.testing.assert_allclose(got.mean(0), ref.mean(0), atol=tol)
    for j in range(k):
        c_got, c_ref = np.cov(got[:, j].T), np.cov(ref[:, j].T)
        np.testing.assert_allclose(np.sqrt(np.abs(c_got)), np.sqrt(np.abs(c_ref)), atol=2 * tol)
    some = NaiveSampler(sample_indices=(1, 3))(
        torch.Generator().manual_seed(2), torch.as_tensor(mu), torch.as_tensor(cov),
        None if alpha is None else torch.as_tensor(alpha), n=5).numpy()
    np.testing.assert_array_equal(some[:, [0, 2]], np.broadcast_to(mu[[0, 2]], (5, 2, 2)))
    assert (some[:, [1, 3]] != mu[[1, 3]]).all()
