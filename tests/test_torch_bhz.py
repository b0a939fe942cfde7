"""The complex path of the port against the JAX package, on the complex BHZ
case of tests/bhz_case.py (Ns=6, every sector complex; at
lanc_dim_threshold=16 both batched and serial complex Lanczos sectors
run).  The JAX side runs its split-plane kit (CDMFT_SPLIT_BACKEND=1), the
algorithm the port carries, in complex128, through two CDMFT iterations
whose first solve is at the initial bath; its solve and its loop are
shared by every test here.

* The model module: hloc, H(k) and the bath basis equal JAX's bit for bit.
* The general bath: dimension, flat layout (byte-equal through
  carry.state_from_numpy) and Delta(z) to 1e-12.
* One solve at the initial bath: egs, dens, docc and both density
  matrices to 1e-9; Sigma(iw) to 1e-9 relative under "complex128" and to
  5e-5 under "mixed" (the JAX suite's config-5 mixed-vs-f64 bound,
  tests/test_mixed_baseline_configs.py:198).
* Time reversal: H_dw is the complex conjugate of H_up, so the spin-up
  and spin-down diagonals of Sigma agree.  Measured on this case: ~1e-12
  relative after the first solve, ~1e-9 after a chi^2 fit (the fit stops
  at its gradient tolerance); both packages are held to 1e-6.
* ed_gf_precision="single": the GF chains run in complex64 through the
  fused wrapper; G(iw) within 1e-5 of JAX's single-precision G(iw) and
  within 1e-3 of complex128.
* Two loop iterations with the chi^2 fit: bath, Weiss field and Sigma to
  1e-5 relative after each, as tests/test_torch_dmft_loop.py holds the
  real loop.  Measured: the first Sigma and Weiss field agree to 2e-12,
  the first fitted bath to 1e-8 (scipy's CG stops at gtol on gradients
  that differ in the last digits), and that moves the second egs by
  1.1e-7, so egs is held to 5e-7 after two iterations.

A ComplexWarning (an imaginary part dropped) fails the test.
"""
import dataclasses

import numpy as np
import pytest
import threadpoolctl
import torch

import bhz_case
import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_tpu import dmft_loop as jloop
from cdmft_lanc_ed_tpu.models import bhz as jbhz
from cdmft_lanc_ed_torch import diag as tdiag
from cdmft_lanc_ed_torch import dmft_loop as tloop
from cdmft_lanc_ed_torch.carry import state_from_numpy
from cdmft_lanc_ed_torch.models import bhz as tbhz
from cdmft_lanc_ed_torch.ops import fused
from cdmft_lanc_ed_torch.ops import split as tsplit

pytestmark = pytest.mark.filterwarnings(
    "error::numpy.exceptions.ComplexWarning")


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


LOOP_KW = dict(bhz_case.KW, lfit=32, nloop=2, dmft_error=1e-10,
               cg_niter=300, cg_ftol=1e-8)
RTOL_LOOP = 1e-5
TR_TOL = 1e-6
RTOL_GF_SINGLE = 1e-5


def _tr_gap(sm):
    """max |Sigma_up,aa - Sigma_dw,aa| relative to max |Sigma|."""
    gap = max(float(np.abs(sm[0, 0, 0, 0, o, o] - sm[0, 0, 1, 1, o, o])
                    .max()) for o in range(sm.shape[4]))
    return gap / float(np.abs(sm).max())


def _run_loop(pkg, loop_mod, bhz, workdir, monkeypatch, **solver_kw):
    cfg = pkg.EDConfig(work_dir=str(workdir), **LOOP_KW)
    solver = pkg.EDSolver(cfg, **solver_kw)
    _, basis, lams = bhz_case.model(bhz)
    solver.set_hbath(basis, lams)
    bath = solver.init_solver()
    hk, hloc = bhz_case.lattice(bhz)
    record = []
    fit = loop_mod.chi2_fitgf

    def recording_fit(cfg_, hb, weiss, bath_, **kw):
        out = fit(cfg_, hb, weiss, bath_, **kw)
        record.append(dict(
            weiss=np.array(weiss), fitted=np.array(out[0]),
            sigma=np.array(solver.sigma_matsubara()), egs=solver.egs,
            dens=np.array(solver.dens()), docc=np.array(solver.docc()),
            cdm=np.array(solver.cluster_dm()), spdm=np.array(solver.sp_dm()),
            g0imp=np.array(solver.g0imp_matsubara())))
        return out

    monkeypatch.setattr(loop_mod, "chi2_fitgf", recording_fit)
    res = loop_mod.run_dmft_loop(solver, hk, hloc, bath, wmixing=0.5,
                                 max_loops=2)
    return cfg, np.array(bath), res, record


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    # the JAX side on its split-plane kit, the algorithm the port has
    mp.setenv("CDMFT_SPLIT_BACKEND", "1")
    try:
        jrun = _run_loop(jpkg, jloop, jbhz, tmp_path_factory.mktemp("jax"),
                         mp)
        trun = _run_loop(tpkg, tloop, tbhz, tmp_path_factory.mktemp("torch"),
                         mp, device="cpu")
    finally:
        mp.undo()
    return jrun, trun


def test_model_matches_jax():
    kw = bhz_case.MODEL
    for ispin in (0, 1):
        assert np.array_equal(tbhz.t_x(0.25, 0.3, ispin),
                              jbhz.t_x(0.25, 0.3, ispin))
    assert np.array_equal(tbhz.t_m(0.5), jbhz.t_m(0.5))
    assert np.array_equal(tbhz.t_y(0.25, 0.3), jbhz.t_y(0.25, 0.3))
    for nx, ny in ((1, 1), (2, 1), (2, 2)):
        assert np.array_equal(tbhz.bhz_cluster_hloc(nx, ny, **kw),
                              jbhz.bhz_cluster_hloc(nx, ny, **kw))
        for a, b in zip(tbhz.bhz_bath_basis(nx, ny, **kw),
                        jbhz.bhz_bath_basis(nx, ny, **kw)):
            assert np.array_equal(a, b)
        for fn in ("bhz_cluster_hk", "bhz_chain_hk"):
            for a, b in zip(getattr(tbhz, fn)(nx, ny, 4, **kw),
                            getattr(jbhz, fn)(nx, ny, 4, **kw)):
                assert np.array_equal(a, b)
    for a, b in zip(tbhz.bhz_alternated_hk(4, **kw),
                    jbhz.bhz_alternated_hk(4, **kw)):
        assert np.array_equal(a, b)
    # the case's lattice carries its complex on-site term in H(k) too
    hk, hloc = bhz_case.lattice(tbhz)
    np.testing.assert_allclose(hk.mean(axis=0), tpkg.nnn2lso(hloc, 1, 2, 2),
                               rtol=0, atol=1e-15)


def test_general_bath_matches_jax():
    """The general bath at Nspin=2 with a complex basis: dimension, flat
    layout, pack/unpack and Delta(z)."""
    jcfg = jpkg.EDConfig(**bhz_case.KW)
    _, basis, lams = bhz_case.model(jbhz)
    jhb = jpkg.set_hbath(basis, lams, jcfg)
    jb = jpkg.bath.init_dmft_bath(jcfg, jhb)
    jb.v[:] = np.linspace(0.2, 0.9, jb.v.size).reshape(jb.v.shape)
    jarr = jpkg.pack_dmft_bath(jcfg, jb)
    cfg, hb, bath = state_from_numpy(dataclasses.asdict(jcfg), basis, lams,
                                     jarr, device="cpu")
    assert tpkg.get_bath_dimension(cfg, hb.nsym) \
        == jpkg.get_bath_dimension(jcfg, jhb.nsym) == len(jarr)
    assert bath.numpy().tobytes() == np.asarray(jarr).tobytes()
    tb = tpkg.unpack_dmft_bath(cfg, bath)
    assert np.array_equal(tb.v, jb.v) and np.array_equal(tb.lam, jb.lam)
    assert tpkg.pack_dmft_bath(cfg, tb).tobytes() \
        == np.asarray(jarr).tobytes()
    z = 1j * np.pi / cfg.beta * (2 * np.arange(8) + 1)
    dt = tpkg.delta_bath(cfg, hb, tb, z, device="cpu")
    dj = np.asarray(jpkg.delta_bath(jcfg, jhb, jb, z))
    assert dt.shape == (1, 1, 2, 2, 2, 2, 8)
    np.testing.assert_allclose(dt, dj, rtol=1e-12,
                               atol=1e-12 * np.abs(dj).max())
    assert np.abs(dt.imag).max() > 0.0


@pytest.mark.parametrize("prec,sig_rtol", [("complex128", 1e-9),
                                           ("mixed", 5e-5)])
def test_solve_matches_jax(tmp_path, runs, monkeypatch, prec, sig_rtol):
    (jcfg, jbath, _, jrec), _ = runs
    ref = jrec[0]                       # the JAX solve at the initial bath
    kinds = []
    batched, serial = tdiag._solve_batched, tdiag._solve_serial

    def spy_batched(cfg, members, key, *a):
        kinds.append(("batched", key[-1]))
        return batched(cfg, members, key, *a)

    def spy_serial(cfg, op, *a):
        kinds.append(("serial", tsplit.op_is_real(op)))
        return serial(cfg, op, *a)

    monkeypatch.setattr(tdiag, "_solve_batched", spy_batched)
    monkeypatch.setattr(tdiag, "_solve_serial", spy_serial)
    fields = dataclasses.asdict(jcfg)
    fields.update(ed_precision=prec, work_dir=str(tmp_path))
    _, basis, lams = bhz_case.model(tbhz)
    _, hloc = bhz_case.lattice(tbhz)
    cfg, hb, bath = state_from_numpy(fields, basis, lams, jbath,
                                     device="cpu")
    s = tpkg.EDSolver(cfg, device="cpu")
    s.hb = hb
    s.init_solver()
    s.solve(bath, hloc)
    assert {("batched", False), ("serial", False)} <= set(kinds)
    assert all(not real for _, real in kinds)
    assert s.egs == pytest.approx(ref["egs"], abs=1e-9)
    np.testing.assert_allclose(s.dens(), ref["dens"], atol=1e-9)
    np.testing.assert_allclose(s.docc(), ref["docc"], atol=1e-9)
    np.testing.assert_allclose(s.cluster_dm(), ref["cdm"], atol=1e-9)
    np.testing.assert_allclose(s.sp_dm(), ref["spdm"], atol=1e-9)
    assert np.abs(s.sp_dm().imag).max() > 0.0          # complex states
    sig = s.sigma_matsubara()
    np.testing.assert_allclose(sig, ref["sigma"], rtol=sig_rtol,
                               atol=sig_rtol * np.abs(ref["sigma"]).max())
    np.testing.assert_allclose(s.g0imp_matsubara(), ref["g0imp"],
                               rtol=1e-12, atol=1e-12)
    assert s.gf.spectrum.symmetric is False           # the 4-channel scheme
    assert _tr_gap(sig) < TR_TOL and _tr_gap(ref["sigma"]) < TR_TOL


@pytest.mark.parametrize("it", [0, 1])
def test_loop_iteration_matches_jax(runs, it):
    (_, _, _, jrec), (_, _, _, trec) = runs
    assert len(trec) == len(jrec) == 2
    for key in ("sigma", "weiss", "fitted"):
        b = jrec[it][key]
        np.testing.assert_allclose(trec[it][key], b, rtol=RTOL_LOOP,
                                   atol=RTOL_LOOP * np.abs(b).max())
    assert _tr_gap(trec[it]["sigma"]) < TR_TOL
    assert _tr_gap(jrec[it]["sigma"]) < TR_TOL


def test_loop_final_state_matches_jax(runs):
    (_, _, jr, _), (_, _, tr, _) = runs
    assert tr.iterations == jr.iterations == 2
    for a, b in ((tr.bath, jr.bath), (tr.weiss, jr.weiss)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=RTOL_LOOP,
                                   atol=RTOL_LOOP * np.abs(b).max())
    assert tr.solver.egs == pytest.approx(jr.solver.egs, abs=5e-7)
    assert np.isfinite(tr.solver.sigma_matsubara()).all()


def test_gf_single_precision_runs_the_kernel(tmp_path, monkeypatch):
    """ed_gf_precision="single" runs the complex GF chains in complex64
    through the fused wrapper.  Its G(iw) is held to the JAX package's
    single-precision G(iw) (split-plane kit, the same f32 chains) to
    RTOL_GF_SINGLE, and to the complex128 G(iw) to the JAX package's bound
    for single against double (1e-3, tests/test_real_fastpath.py:369).
    Measured, relative to max|G|: port single vs JAX single 2.0e-6, each
    within 1.5e-6 of complex128 (rounding in two f32 chains)."""
    calls = []
    real = fused.fused_pair_matvec

    def spy(*args):
        calls.append(args[-1].dtype)
        return real(*args)

    monkeypatch.setattr(fused, "fused_pair_matvec", spy)
    monkeypatch.setenv("CDMFT_SPLIT_BACKEND", "1")
    _, basis, lams = bhz_case.model(tbhz)
    _, hloc = bhz_case.lattice(tbhz)
    gmats = {}
    for pkg, kw in ((tpkg, dict(device="cpu")), (jpkg, {})):
        for prec in ("double", "single"):
            if pkg is jpkg and prec == "double":
                continue
            cfg = pkg.EDConfig(**bhz_case.KW, ed_gf_precision=prec,
                               work_dir=str(tmp_path))
            s = pkg.EDSolver(cfg, **kw)
            s.set_hbath(basis, lams)
            bath = s.init_solver()
            calls.clear()
            s.solve(bath, hloc)
            gmats[pkg.__name__, prec] = np.asarray(s.gimp_matsubara())
            if pkg is tpkg:
                assert (len(calls) > 0) == (prec == "single")
                if calls:
                    assert set(calls) == {torch.complex64}
    single = gmats[tpkg.__name__, "single"]
    jsingle = gmats[jpkg.__name__, "single"]
    np.testing.assert_allclose(single, jsingle, rtol=RTOL_GF_SINGLE,
                               atol=RTOL_GF_SINGLE * np.abs(jsingle).max())
    np.testing.assert_allclose(single, gmats[tpkg.__name__, "double"],
                               rtol=1e-3, atol=1e-3)
