"""Two CDMFT iterations of the port against the JAX package: the 2x2
plaquette + 1 replica bath configuration of
tests/test_dmft_loop.py:60-79 (beta=8, lmats=lfit=32, nk=4, wmixing 0.7),
with ed_twin and one state per sector to keep the JAX side's compile time
inside the test budget.  The JAX side runs its split-plane real kit
(CDMFT_SPLIT_BACKEND=1), the algorithm the port carries.

After each iteration the fitted bath, the Weiss field and Sigma(iw) of the
two packages agree to 1e-5 relative.  The CG fit is the loosest stage:
scipy stops it at gtol=cg_ftol on gradients that differ in the last
digits, so the first fitted bath agrees to 5e-9 while the first Sigma and
Weiss field agree to 2e-13; the second iteration inherits that (Sigma
6e-9, egs 2.8e-8).  Hence egs is held to 1e-7 after two iterations.
"""
import numpy as np
import pytest
import threadpoolctl
import torch

import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_tpu import dmft_loop as jloop
from cdmft_lanc_ed_tpu.models.hubbard import square_cluster_hk as jhk
from cdmft_lanc_ed_torch import dmft_loop as tloop
from cdmft_lanc_ed_torch.models.hubbard import square_cluster_hk as thk


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


KW = dict(nlat=4, norb=1, nspin=1, nbath=1, uloc=[4.0], beta=8.0, lmats=32,
          lreal=32, lfit=32, lanc_ngfiter=32, dmft_error=1e-10, nloop=2,
          ed_verbose=0, cg_niter=300, cg_ftol=1e-8, ed_twin=True,
          lanc_nstates_sector=1)
RTOL = 1e-5


def _run(pkg, loop_mod, hk_fn, workdir, monkeypatch, **solver_kw):
    cfg = pkg.EDConfig(work_dir=str(workdir), **KW)
    solver = pkg.EDSolver(cfg, **solver_kw)
    basis = np.zeros((1, 4, 4, 1, 1, 1, 1), np.complex128)
    for il in range(4):
        basis[0, il, il, 0, 0, 0, 0] = 1.0
    solver.set_hbath(basis, np.linspace(-1.0, 1.0, 1)[:, None])
    bath = solver.init_solver()
    hk, hloc = hk_fn(2, 2, nk=4)
    record = []
    fit = loop_mod.chi2_fitgf

    def recording_fit(cfg_, hb, weiss, bath_, **kw):
        out = fit(cfg_, hb, weiss, bath_, **kw)
        record.append(dict(weiss=np.array(weiss), fitted=np.array(out[0]),
                           sigma=np.array(solver.sigma_matsubara())))
        return out

    monkeypatch.setattr(loop_mod, "chi2_fitgf", recording_fit)
    res = loop_mod.run_dmft_loop(solver, hk, hloc, bath, wmixing=0.7,
                                 max_loops=2)
    return res, record


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    # the JAX side on its real split-plane kit, the algorithm the port has
    mp.setenv("CDMFT_SPLIT_BACKEND", "1")
    try:
        jres = _run(jpkg, jloop, jhk, tmp_path_factory.mktemp("jax"), mp)
        tres = _run(tpkg, tloop, thk, tmp_path_factory.mktemp("torch"), mp,
                    device="cpu")
    finally:
        mp.undo()
    return jres, tres


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max())


@pytest.mark.parametrize("it", [0, 1])
def test_iteration_matches_jax(runs, it):
    (_, jrec), (_, trec) = runs
    assert len(trec) == len(jrec) == 2
    for key in ("sigma", "weiss", "fitted"):
        _close(trec[it][key], jrec[it][key])


def test_final_state_matches_jax(runs):
    (jr, _), (tr, _) = runs
    assert tr.iterations == jr.iterations == 2
    _close(tr.bath, jr.bath)
    _close(tr.weiss, jr.weiss)
    assert tr.solver.egs == pytest.approx(jr.solver.egs, abs=1e-7)


def test_physics_of_the_loop(runs):
    """PH symmetry and the C4 symmetry of the cluster, as the JAX test
    checks them."""
    (_, _), (tr, _) = runs
    np.testing.assert_allclose(tr.solver.dens(), 1.0, atol=1e-5)
    d = tr.solver.docc().ravel()
    np.testing.assert_allclose(d, d[0], atol=1e-6)
    assert 0.0 < d[0] < 0.25
    sm = tr.solver.sigma_matsubara()
    for il in range(1, 4):
        assert sm[il, il, 0, 0, 0, 0, 0] == pytest.approx(
            sm[0, 0, 0, 0, 0, 0, 0], abs=1e-6)
