"""The port's lattice leftovers, the chemical-potential search and the doped
loop against the JAX package, on seeded inputs.

* ``build_hk``, ``dmft_gloc_realaxis`` and ``dmft_kinetic_energy`` (its
  inverses chunked by 256 frequencies; 300 frequencies here, so two
  chunks) on the 2x2 plaquette lattice with a random self-energy: 1e-12
  relative.
* ``MuSearch`` and ``VariableSearch`` driven by the density models of
  tests/test_parity_round2.py:89-130: the same mu sequence, bit for bit,
  and byte-identical files (``xmu.restart``, ``search_mu_iteration.ed``,
  ``var_compressibility.{restart,used}``,
  ``search_variable_iteration_info.ed``).
* BASELINE config 2 (single site + 4 replica baths) with nread=0.9 on a
  semicircular DOS (``bethe_hk``), three iterations of both packages'
  ``run_dmft_loop``: mu per iteration to 1e-10, the density to 1e-8, the
  fitted bath, the Weiss field and Sigma to
  tests/test_torch_dmft_loop.py's RTOL.
* A mu that changes between two solves reaches the second one: a solve
  at mu=0, then ``cfg.xmu = -0.3`` and a second solve, equals a fresh
  solver's solve at -0.3 (given the same adapted per-sector state counts,
  the reference's finite-T bookkeeping) to 1e-12 in egs and Sigma.
* BASELINE configs 2 and 3 (tests/test_mixed_baseline_configs.py:70-95)
  through the port, "mixed" against "complex128" at that file's bounds:
  E0 1e-7, Sigma 2e-5 relative (atol 1e-5), dens and cluster DM 1e-6.
"""
import dataclasses
import os

import numpy as np
import pytest
import threadpoolctl
import torch

import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_tpu import dmft_loop as jloop
from cdmft_lanc_ed_tpu import lattice as jlat
from cdmft_lanc_ed_tpu.models import hubbard as jhub
from cdmft_lanc_ed_torch import dmft_loop as tloop
from cdmft_lanc_ed_torch import lattice as tlat
from cdmft_lanc_ed_torch.models import hubbard as thub


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


RTOL = 1e-5                 # tests/test_torch_dmft_loop.py


def _close(a, b, rtol):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


# ---------------------------------------------------------------------------
# lattice functions
# ---------------------------------------------------------------------------

PLAQ = dict(nlat=4, norb=1, nspin=1, beta=20.0, xmu=0.15, wini=-4.0,
            wfin=4.0, eps=0.05)


def _sigma(l, seed):
    """A random causal self-energy [4,4,1,1,1,1,L] (Im < 0 on the
    diagonal)."""
    rng = np.random.default_rng(seed)
    s = 0.2 * (rng.normal(size=(4, 4, 1, 1, 1, 1, l))
               + 1j * rng.normal(size=(4, 4, 1, 1, 1, 1, l)))
    s = 0.5 * (s + np.swapaxes(s, 0, 1))
    for i in range(4):
        s[i, i] = s[i, i].real - 1j * np.abs(s[i, i].imag) - 0.3j
    return s


def test_build_hk_matches_jax():
    kgrid = tlat.build_kgrid(5, 2)
    np.testing.assert_array_equal(kgrid, jlat.build_kgrid(5, 2))

    def model(k):
        return thub.square_cluster_hk(2, 2, nk=1)[0][0] * np.cos(k[0]) \
            + 1j * np.sin(k[1]) * np.eye(4)

    np.testing.assert_array_equal(tlat.build_hk(model, kgrid),
                                  jlat.build_hk(model, kgrid))


def test_gloc_realaxis_matches_jax():
    hk, _ = thub.square_cluster_hk(2, 2, nk=6)
    s = _sigma(40, 1)
    t = tlat.dmft_gloc_realaxis(tpkg.EDConfig(**PLAQ), hk, s, device="cpu")
    j = jlat.dmft_gloc_realaxis(jpkg.EDConfig(**PLAQ), hk, s)
    assert t.shape == s.shape
    _close(t, j, 1e-12)


@pytest.mark.parametrize("nspin", [1, 2])
def test_kinetic_energy_matches_jax(nspin):
    hk, _ = thub.square_cluster_hk(2, 2, nk=6)
    s = _sigma(300, 2)
    cfg_kw = PLAQ
    if nspin == 2:           # spin-diagonal H(k) and Sigma, nspin=2 layout
        z = np.zeros((36, 8, 8), np.complex128)
        z[:, :4, :4] = z[:, 4:, 4:] = hk
        hk = z
        s2 = np.zeros((4, 4, 2, 2, 1, 1, 300), np.complex128)
        s2[:, :, 0, 0] = s2[:, :, 1, 1] = s[:, :, 0, 0]
        s = s2
        cfg_kw = dict(PLAQ, nspin=2)
    t = tlat.dmft_kinetic_energy(tpkg.EDConfig(**cfg_kw), hk, s,
                                 device="cpu")
    j = jlat.dmft_kinetic_energy(jpkg.EDConfig(**cfg_kw), hk, s)
    assert np.isfinite(t) and t < 0.0
    assert t == pytest.approx(j, rel=1e-12, abs=0.0)


# ---------------------------------------------------------------------------
# the searches: same trajectory, same files
# ---------------------------------------------------------------------------

def _drive(cls, kw, var, dens, steps, workdir):
    os.makedirs(workdir)
    search = cls(**kw, work_dir=str(workdir))
    seq = []
    for _ in range(steps):
        var, conv = search.step(var, dens(var), converged=True)
        seq.append((var, conv))
        if conv:
            break
    files = {f: open(os.path.join(workdir, f), "rb").read()
             for f in sorted(os.listdir(workdir))}
    return seq, files


SEARCHES = {
    # tests/test_parity_round2.py:89-110, :125-130 and :113-121
    "mu_walk": ("MuSearch", dict(nread=1.0, ndelta=0.3, nerr=1e-4,
                                 niter=100),
                -1.3, lambda m: 1.0 + np.tanh(0.8 * (m - 0.37)), 200),
    "mu_reduction": ("MuSearch", dict(nread=1.0, ndelta=0.1, nerr=1e-6,
                                      niter=50),
                     0.0, lambda m: 1.0 + 5e-3 + 0.0 * m, 1),
    "mu_giveup": ("MuSearch", dict(nread=1.0, ndelta=0.3, nerr=1e-9,
                                   niter=3),
                  -1.3, lambda m: 1.0 + np.tanh(0.8 * (m - 0.37)), 60),
    "variable_secant": ("VariableSearch", dict(nread=1.0, nerr=1e-5,
                                               ndelta=0.2),
                        -0.8, lambda m: 1.0 + 0.5 * (m - 0.2), 60),
}


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_search_matches_jax(tmp_path, case):
    name, kw, var0, dens, steps = SEARCHES[case]
    tseq, tfiles = _drive(getattr(tlat, name), kw, var0, dens, steps,
                          tmp_path / "torch")
    jseq, jfiles = _drive(getattr(jlat, name), kw, var0, dens, steps,
                          tmp_path / "jax")
    assert len(tseq) > 0 and tseq == jseq
    assert tfiles == jfiles and len(tfiles) >= 2


# ---------------------------------------------------------------------------
# the doped loop: BASELINE config 2 with nread=0.9
# ---------------------------------------------------------------------------

# The fit is driven to its minimum (cg_ftol 1e-12): at 1e-8 scipy's CG
# stops in the flat valley of four one-level replicas, at points up to 7%
# apart for inputs that differ in the last digit (measured: the first
# Weiss fields agree to 1e-12, the fitted baths to 7e-2); at 1e-12 both
# packages reach the same bath to 1e-7.
DOPED_KW = dict(nlat=1, norb=1, nspin=1, nbath=4, uloc=[2.0], beta=100.0,
                lmats=16, lreal=8, lfit=16, lanc_dim_threshold=16,
                ed_verbose=0, nread=0.9, ndelta=0.1, nloop=3,
                dmft_error=1e-10, cg_niter=2000, cg_ftol=1e-12)
CONFIG2_BASIS = np.ones((1, 1, 1, 1, 1, 1, 1), np.complex128)
CONFIG2_LAM = np.array([[-0.5], [0.5], [1.0], [-1.0]])


def _doped_run(pkg, loop_mod, hub, workdir, monkeypatch, **solver_kw):
    cfg = pkg.EDConfig(work_dir=str(workdir), **DOPED_KW)
    solver = pkg.EDSolver(cfg, **solver_kw)
    solver.set_hbath(CONFIG2_BASIS, CONFIG2_LAM)
    bath = solver.init_solver()
    hk, hloc = hub.bethe_hk(64)
    record = []
    fit = loop_mod.chi2_fitgf

    def recording_fit(cfg_, hb, weiss, bath_, **kw):
        out = fit(cfg_, hb, weiss, bath_, **kw)
        record.append(dict(xmu=cfg_.xmu, dens=float(solver.dens().sum()),
                           weiss=np.array(weiss), fitted=np.array(out[0]),
                           sigma=np.array(solver.sigma_matsubara())))
        return out

    monkeypatch.setattr(loop_mod, "chi2_fitgf", recording_fit)
    res = loop_mod.run_dmft_loop(solver, hk, hloc, bath, wmixing=0.7,
                                 max_loops=3)
    return res, record, cfg.xmu


@pytest.fixture(scope="module")
def doped(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("CDMFT_SPLIT_BACKEND", "1")
    try:
        j = _doped_run(jpkg, jloop, jhub, tmp_path_factory.mktemp("jax"),
                       mp)
        t = _doped_run(tpkg, tloop, thub, tmp_path_factory.mktemp("torch"),
                       mp, device="cpu")
    finally:
        mp.undo()
    return j, t


def test_doped_loop_mu_matches_jax(doped):
    (jres, jrec, jmu), (tres, trec, tmu) = doped
    assert tres.iterations == jres.iterations == 3
    assert len(trec) == len(jrec) == 3
    tm = [r["xmu"] for r in trec] + [tmu]
    jm = [r["xmu"] for r in jrec] + [jmu]
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-10)
    assert tm[0] == 0.0 and tm[-1] != 0.0             # the search moved mu
    np.testing.assert_allclose([r["dens"] for r in trec],
                               [r["dens"] for r in jrec], atol=1e-8)


@pytest.mark.parametrize("it", [0, 1, 2])
def test_doped_loop_iteration_matches_jax(doped, it):
    (_, jrec, _), (_, trec, _) = doped
    for key in ("sigma", "weiss", "fitted"):
        _close(trec[it][key], jrec[it][key], RTOL)


def test_doped_loop_final_state(doped, tmp_path):
    (jres, _, _), (tres, _, tmu) = doped
    _close(tres.bath, jres.bath, RTOL)
    _close(tres.weiss, jres.weiss, RTOL)
    wd = tres.solver.cfg.work_dir
    toks = open(os.path.join(wd, "xmu.restart")).read().split()
    assert float(toks[0]) == pytest.approx(tmu, abs=1e-12)
    assert len(open(os.path.join(wd, "search_mu_iteration.ed"))
               .read().splitlines()) == 3


# ---------------------------------------------------------------------------
# a changed mu reaches the next solve
# ---------------------------------------------------------------------------

def _config2_solver(workdir, **kw):
    os.makedirs(workdir)
    cfg = tpkg.EDConfig(**dict(DOPED_KW, nread=0.0, work_dir=str(workdir),
                               **kw))
    s = tpkg.EDSolver(cfg, device="cpu")
    s.set_hbath(CONFIG2_BASIS, CONFIG2_LAM)
    return s, s.init_solver()


def test_changed_mu_reaches_the_next_solve(tmp_path):
    hloc = np.zeros((1, 1, 1, 1, 1, 1), np.complex128)
    a, bath = _config2_solver(tmp_path / "a")
    a.solve(bath, hloc)
    egs0, sig0 = a.egs, a.sigma_matsubara().copy()
    neigen = a.diag_state.neigen_sector.copy()
    ntot = a.diag_state.lanc_nstates_total
    a.cfg.xmu = -0.3
    a.solve(bath, hloc)
    b, _ = _config2_solver(tmp_path / "b", xmu=-0.3)
    b.diag_state.neigen_sector[:] = neigen
    b.diag_state.lanc_nstates_total = ntot
    b.solve(bath, hloc)
    assert abs(a.egs - egs0) > 1e-3                    # mu moved the physics
    assert a.egs == pytest.approx(b.egs, abs=1e-12)
    _close(a.sigma_matsubara(), b.sigma_matsubara(), 1e-12)
    assert np.abs(a.sigma_matsubara() - sig0).max() > 1e-3


# ---------------------------------------------------------------------------
# BASELINE configs 2 and 3, mixed against complex128
# ---------------------------------------------------------------------------

def _config3():
    hloc = np.zeros((2, 2, 1, 1, 1, 1), np.complex128)
    hloc[0, 1, 0, 0, 0, 0] = hloc[1, 0, 0, 0, 0, 0] = -1.0
    basis = np.zeros((1, 2, 2, 1, 1, 1, 1), np.complex128)
    for il in range(2):
        basis[0, il, il, 0, 0, 0, 0] = 1.0
    kw = dict(nlat=2, norb=1, nspin=1, nbath=2, uloc=[3.0])
    return kw, hloc, basis, np.array([[0.4], [-0.4]])


BASELINE = {
    "config2": (dict(nlat=1, norb=1, nspin=1, nbath=4, uloc=[2.0]),
                np.zeros((1, 1, 1, 1, 1, 1), np.complex128), CONFIG2_BASIS,
                CONFIG2_LAM),
    "config3": _config3(),
}


@pytest.mark.parametrize("name", sorted(BASELINE))
def test_baseline_config_mixed_vs_complex128(tmp_path, name):
    kw, hloc, basis, lam = BASELINE[name]
    out = {}
    for prec in ("complex128", "mixed"):
        os.makedirs(tmp_path / prec)
        cfg = tpkg.EDConfig(ed_precision=prec, lmats=16, lreal=8,
                            dm_flag=True, lanc_dim_threshold=16,
                            ed_verbose=0, work_dir=str(tmp_path / prec),
                            **kw)
        s = tpkg.EDSolver(cfg, device="cpu")
        s.set_hbath(basis, lam)
        b = s.init_solver()
        s.solve(b, hloc)
        out[prec] = s
    f64, mx = out["complex128"], out["mixed"]
    assert abs(f64.egs - mx.egs) < 1e-7
    np.testing.assert_allclose(mx.dens(), f64.dens(), atol=1e-6)
    np.testing.assert_allclose(mx.sigma_matsubara(), f64.sigma_matsubara(),
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(mx.cluster_dm(), f64.cluster_dm(), atol=1e-6)


def test_config_fields_match_jax():
    """The loop reads nread/ndelta/nerr/nloop from the same config fields
    with the same defaults in both packages."""
    t, j = tpkg.EDConfig(), jpkg.EDConfig()
    for f in ("nread", "ndelta", "nerr", "nloop", "xmu", "ncoeff"):
        assert getattr(t, f) == getattr(j, f)
    assert {f.name for f in dataclasses.fields(t)} \
        == {f.name for f in dataclasses.fields(j)}
