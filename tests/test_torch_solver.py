"""One solve of the port against the physics anchors and the JAX package.

* The bath-less U=4 half-filled plaquette: EGS -6.1027484835,
  dens 1.0 per site, docc 0.0718 (lanc_dim_threshold=16 sends the
  (2,2) sector through the serial Lanczos path and two pairs of sectors
  through the batched one).
* The plaquette + 1 replica bath (Ns=8), one solve: egs to 1e-9, dens,
  docc and both density matrices (dm_flag) to 1e-9, Sigma(iw) to 2e-5
  relative under "mixed" (the
  reference's mixed-vs-f64 bound) and 1e-9 under "complex128".  Both
  sides start from one bath built through carry.state_from_numpy.  The
  sweep uses ed_twin and one state per sector to keep the JAX side's
  compile time inside the test budget.
"""
import dataclasses

import numpy as np
import pytest
import threadpoolctl
import torch

import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_torch.carry import state_from_numpy


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


EGS_PLAQUETTE = -6.1027484835


def _plaquette_hloc():
    h = np.zeros((4, 4, 1, 1, 1, 1), np.complex128)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        h[i, j, 0, 0, 0, 0] = h[j, i, 0, 0, 0, 0] = -1.0
    return h


@pytest.mark.parametrize("prec", ["complex128", "mixed"])
def test_plaquette_anchor(tmp_path, prec):
    cfg = tpkg.EDConfig(nlat=4, norb=1, nspin=1, nbath=0, uloc=[4.0],
                        lmats=32, lreal=32, ed_verbose=0,
                        lanc_dim_threshold=16, ed_precision=prec,
                        work_dir=str(tmp_path))
    s = tpkg.EDSolver(cfg, device="cpu")
    s.init_solver()
    s.solve(np.zeros(0), _plaquette_hloc())
    assert s.egs == pytest.approx(EGS_PLAQUETTE, abs=1e-8)
    np.testing.assert_allclose(s.dens(), 1.0, atol=1e-10)
    np.testing.assert_allclose(s.docc(), 0.0718, atol=1e-3)
    assert set(s.timers.totals) >= {"diagonalization", "greens_functions",
                                    "observables"}


KW = dict(nlat=4, norb=1, nspin=1, nbath=1, uloc=[4.0], beta=8.0, lmats=32,
          lreal=16, lanc_ngfiter=32, ed_verbose=0, ed_twin=True,
          lanc_nstates_sector=1, dm_flag=True)


def _basis():
    basis = np.zeros((1, 4, 4, 1, 1, 1, 1), np.complex128)
    for il in range(4):
        basis[0, il, il, 0, 0, 0, 0] = 1.0
    return basis, np.array([[-0.5]])


@pytest.fixture(scope="module")
def jax_solve(tmp_path_factory):
    cfg = jpkg.EDConfig(work_dir=str(tmp_path_factory.mktemp("jax")), **KW)
    s = jpkg.EDSolver(cfg)
    s.set_hbath(*_basis())
    bath = s.init_solver()
    with pytest.MonkeyPatch.context() as mp:
        # the JAX side on its real split-plane kit, the port's algorithm
        mp.setenv("CDMFT_SPLIT_BACKEND", "1")
        s.solve(bath, _plaquette_hloc())
    return cfg, bath, s


@pytest.mark.parametrize("prec,sig_rtol", [("complex128", 1e-9),
                                           ("mixed", 2e-5)])
def test_bath_solve_matches_jax(tmp_path, jax_solve, prec, sig_rtol):
    jcfg, jbath, js = jax_solve
    fields = dataclasses.asdict(jcfg)
    fields.update(ed_precision=prec, work_dir=str(tmp_path))
    cfg, hb, bath = state_from_numpy(fields, *_basis(), jbath, device="cpu")
    assert bath.numpy().tobytes() == np.asarray(jbath).tobytes()
    s = tpkg.EDSolver(cfg, device="cpu")
    s.hb = hb
    s.init_solver()
    s.solve(bath, _plaquette_hloc())
    assert s.egs == pytest.approx(js.egs, abs=1e-9)
    np.testing.assert_allclose(s.dens(), js.dens(), atol=1e-9)
    np.testing.assert_allclose(s.docc(), js.docc(), atol=1e-9)
    sig_j = js.sigma_matsubara()
    np.testing.assert_allclose(s.sigma_matsubara(), sig_j, rtol=sig_rtol,
                               atol=sig_rtol * np.abs(sig_j).max())
    np.testing.assert_allclose(s.g0imp_matsubara(), js.g0imp_matsubara(),
                               rtol=1e-12, atol=1e-12)
    # dm_flag: cluster and single-particle density matrices
    np.testing.assert_allclose(s.cluster_dm(), js.cluster_dm(), atol=1e-9)
    np.testing.assert_allclose(s.sp_dm(), js.sp_dm(), atol=1e-9)


def test_pack_roundtrip_matches_jax():
    """pack_dmft_bath of the port reproduces the JAX package's flat bath
    byte for byte (replica bath with 2 replicas, 2 symmetry terms)."""
    kw = dict(KW, nbath=2)
    basis = np.zeros((2, 4, 4, 1, 1, 1, 1), np.complex128)
    for il in range(4):
        basis[0, il, il, 0, 0, 0, 0] = 1.0
    basis[1] = _plaquette_hloc()
    lam = np.array([[-0.7, 0.2], [0.4, -0.1]])
    jcfg = jpkg.EDConfig(**kw)
    jhb = jpkg.set_hbath(basis, lam, jcfg)
    jb = jpkg.pack_dmft_bath(jcfg, jpkg.bath.init_dmft_bath(jcfg, jhb))
    cfg, hb, bath = state_from_numpy(dataclasses.asdict(jcfg), basis, lam,
                                     jb, device="cpu")
    tb = tpkg.pack_dmft_bath(cfg, tpkg.unpack_dmft_bath(cfg, bath))
    assert tb.tobytes() == np.asarray(jb).tobytes()
    assert np.array_equal(hb.basis, jhb.basis)
    with pytest.raises(ValueError):
        state_from_numpy(dataclasses.asdict(jcfg), basis, lam, jb[:-1],
                         device="cpu")
