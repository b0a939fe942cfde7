"""The port's reference-format IO against the JAX package.

One solve of BASELINE config 3 cut to one replica bath (a 2-site chain,
Ns=4, dm_flag) in each package, each in its own work_dir.

* The two solves write the same set of file names.
* Given the port's results, each printer of the port and its JAX
  counterpart write byte-identical files under the same names
  (``print_impsigma/g/g0``, ``write_observables``, ``write_energy``,
  ``write_zeta_and_sig``, ``print_cluster_dm``, ``print_reduced_dm``,
  ``save_gfmatrix``).
* A file written by either package reads back through the other's reader
  exactly (the splot format prints 19 significant digits, so a float64
  survives the round trip): ``read_impsigma``, ``read_impg``, the
  ``_lattice`` readers and ``read_gfmatrix``.
* The solver's readers: a fresh solver on the same work_dir gives back
  the last in-memory Sigma and G exactly; ``gf_cluster(1j*wm)`` equals
  ``gimp_matsubara()`` to 1e-10; ``reduced_dm`` equals JAX's
  ``get_reduced_dm`` of the same cluster DM to 1e-14.
"""
import os

import numpy as np
import pytest
import threadpoolctl
import torch

import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_tpu import io as jio
from cdmft_lanc_ed_torch import io as tio
from cdmft_lanc_ed_torch.gf import GFResult


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One BLAS and one intra-op thread: the suite runs in several worker
    processes at once, and numpy's spinning OpenBLAS pools would
    oversubscribe the cores many times over."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(nthreads)


# BASELINE config 3 (tests/test_mixed_baseline_configs.py:84-95) with one
# bath instead of two: the JAX side compiles fewer sector shapes
KW = dict(nlat=2, norb=1, nspin=1, nbath=1, uloc=[3.0], lmats=16, lreal=8,
          dm_flag=True, lanc_dim_threshold=16, ed_verbose=0)
LAM = np.array([[0.4]])
MASK = np.array([[True], [False]])          # keep site 1 of the chain


def _model():
    hloc = np.zeros((2, 2, 1, 1, 1, 1), np.complex128)
    hloc[0, 1, 0, 0, 0, 0] = hloc[1, 0, 0, 0, 0, 0] = -1.0
    basis = np.zeros((1, 2, 2, 1, 1, 1, 1), np.complex128)
    for il in range(2):
        basis[0, il, il, 0, 0, 0, 0] = 1.0
    return hloc, basis


def _solve(pkg, workdir, **solver_kw):
    os.makedirs(workdir)
    cfg = pkg.EDConfig(work_dir=str(workdir), **KW)
    s = pkg.EDSolver(cfg, **solver_kw)
    hloc, basis = _model()
    s.set_hbath(basis, LAM)
    s.solve(s.init_solver(), hloc)
    return s


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    root = tmp_path_factory.mktemp("io")
    return (_solve(jpkg, root / "jax"),
            _solve(tpkg, root / "torch", device="cpu"))


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def test_solves_write_the_same_names(solves):
    js, ts = solves
    names = set(os.listdir(ts.cfg.work_dir))
    assert names == set(os.listdir(js.cfg.work_dir))
    assert "impSigma_Isite0001_Jsite0002_l11_s1_iw.ed" in names
    assert "cluster_density_matrix.dat" in names
    # the physics of the two solves agree as tests/test_torch_solver.py
    # holds them (the files then differ only in the last digits)
    assert ts.egs == pytest.approx(js.egs, abs=1e-9)


def _print(pkg_io, cfg, ts, which):
    if which in ("print_impsigma", "print_impg", "print_impg0"):
        getattr(pkg_io, which)(cfg, ts.gf)
    elif which == "write_observables":
        pkg_io.write_observables(cfg, ts.obs, ts.egs, cfg.ed_file_suffix)
        pkg_io.write_observables(cfg, ts.obs, ts.egs, cfg.ed_file_suffix)
    elif which == "write_energy":
        pkg_io.write_energy(cfg, ts.energy)
    elif which == "write_zeta_and_sig":
        pkg_io.write_zeta_and_sig(cfg, ts.gf.smats)
    elif which == "print_cluster_dm":
        pkg_io.print_cluster_dm(cfg, ts.cdm)
    elif which == "print_reduced_dm":
        pkg_io.print_reduced_dm(cfg, ts.reduced_dm(MASK), MASK)
    elif which == "save_gfmatrix":
        pkg_io.save_gfmatrix(cfg, ts.gf.spectrum,
                             os.path.join(cfg.work_dir, "gfmatrix.ed"))


@pytest.mark.parametrize("which", [
    "print_impsigma", "print_impg", "print_impg0", "write_observables",
    "write_energy", "write_zeta_and_sig", "print_cluster_dm",
    "print_reduced_dm", "save_gfmatrix"])
def test_printer_writes_jax_bytes(tmp_path, solves, which):
    _, ts = solves
    out = {}
    for name, pkg, pkg_io in (("torch", tpkg, tio), ("jax", jpkg, jio)):
        os.makedirs(tmp_path / name)
        cfg = pkg.EDConfig(work_dir=str(tmp_path / name), **KW)
        _print(pkg_io, cfg, ts, which)
        out[name] = _files(tmp_path / name)
    assert out["torch"] and out["torch"] == out["jax"]


def test_files_read_across_packages(solves):
    js, ts = solves
    for src, other_io in ((ts, jio), (js, tio)):
        for reader, attrs in (("read_impsigma", ("smats", "sreal")),
                              ("read_impg", ("gmats", "greal"))):
            got = getattr(other_io, reader)(src.cfg)
            for a, want in zip(got, attrs):
                np.testing.assert_array_equal(a, getattr(src.gf, want))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_lattice_readers_across_packages(tmp_path, solves, writer):
    """Two inequivalent clusters' files (``_ineq0001``, ``_ineq0002``)
    read back through both packages' lattice readers."""
    _, ts = solves
    pkg, pkg_io = (tpkg, tio) if writer == "torch" else (jpkg, jio)
    cfg = pkg.EDConfig(work_dir=str(tmp_path), **KW)
    for ineq, scale in ((1, 1.0), (2, -0.5)):
        cfg.ed_file_suffix = f"_ineq{ineq:04d}"
        gf = GFResult(**{**ts.gf.__dict__,
                          "smats": scale * ts.gf.smats,
                          "gmats": scale * ts.gf.gmats})
        pkg_io.print_impsigma(cfg, gf)
        pkg_io.print_impg(cfg, gf)
    cfg.ed_file_suffix = ""
    for reader, attr in (("read_impsigma_lattice", "smats"),
                         ("read_impg_lattice", "gmats")):
        t = getattr(tio, reader)(tpkg.EDConfig(work_dir=str(tmp_path), **KW),
                                 2)
        j = getattr(jio, reader)(jpkg.EDConfig(work_dir=str(tmp_path), **KW),
                                 2)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t[0][1], -0.5 * getattr(ts.gf, attr))


def test_solver_readers_round_trip(solves):
    _, ts = solves
    fresh = tpkg.EDSolver(tpkg.EDConfig(work_dir=ts.cfg.work_dir, **KW),
                          device="cpu")
    fresh.read_impsigma()
    fresh.read_impg()
    np.testing.assert_array_equal(fresh.sigma_matsubara(),
                                  ts.sigma_matsubara())
    np.testing.assert_array_equal(fresh.sigma_realaxis(), ts.sigma_realaxis())
    np.testing.assert_array_equal(fresh.gimp_matsubara(), ts.gimp_matsubara())
    np.testing.assert_array_equal(fresh.gimp_realaxis(), ts.gimp_realaxis())
    wm = np.pi / ts.cfg.beta * (2 * np.arange(ts.cfg.lmats) + 1)
    np.testing.assert_allclose(ts.gf_cluster(1j * wm), ts.gimp_matsubara(),
                               rtol=0, atol=1e-10)


def test_reduced_dm_matches_jax(solves):
    js, ts = solves
    rdm = ts.reduced_dm(MASK)
    assert rdm.shape == (4, 4)
    np.testing.assert_allclose(rdm, jio.get_reduced_dm(js.cfg, ts.cdm, MASK),
                               rtol=0, atol=1e-14)
    assert np.trace(rdm).real == pytest.approx(1.0, abs=1e-12)
    np.testing.assert_allclose(ts.reduced_dm(np.ones((2, 1), bool)), ts.cdm,
                               rtol=0, atol=0)


def test_gfmatrix_round_trip(tmp_path, solves):
    _, ts = solves
    spec = ts.gf.spectrum
    path = str(tmp_path / "gfmatrix.ed")
    tio.save_gfmatrix(ts.cfg, spec, path)
    for back in (tio.read_gfmatrix(path), jio.read_gfmatrix(path)):
        assert back.symmetric == spec.symmetric
        assert sorted(back.data) == sorted(spec.data)
        for key in spec.data:
            p0, w0 = spec.flat(key)
            p1, w1 = back.flat(key)
            np.testing.assert_array_equal(p1, p0)
            np.testing.assert_array_equal(w1, w0)
