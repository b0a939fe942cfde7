"""The port's small leftovers against their JAX functions, on seeded inputs.

* Bath helpers: ``hbath_basis_from_hloc`` (and the solver's
  ``set_hbath_from_hloc``) on a complex Kane-Mele Hloc with a mass term,
  ``impose_equal_lambda``, ``impose_bath_offset`` and ``hbath_mask`` in its
  four modes: equal exactly.
* ``gf.tau_grid`` and ``GFSpectrum.evaluate_tau`` on random poles of both
  signs (the overflow-safe branches) and on the spectrum of a solve: 1e-12.
* ``StateList.gs_degeneracy`` at three thresholds: equal.
* ``von_neumann_entropy``, ``site_entanglement_entropy`` and
  ``mutual_information`` on a random density matrix and on the cluster DM
  of the bath-less plaquette: 1e-12.
* ``fock.bjoin`` and ``fock.state_index``: equal exactly.
"""
import numpy as np
import pytest
import threadpoolctl
import torch

import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_tpu import bath as jbath
from cdmft_lanc_ed_tpu import eigenspace as jeig
from cdmft_lanc_ed_tpu import gf as jgf
from cdmft_lanc_ed_tpu import observables as jobs
from cdmft_lanc_ed_tpu.utils import fock as jfock
from cdmft_lanc_ed_torch import bath as tbath
from cdmft_lanc_ed_torch import eigenspace as teig
from cdmft_lanc_ed_torch import gf as tgf
from cdmft_lanc_ed_torch import observables as tobs
from cdmft_lanc_ed_torch.models import kanemele as tkm
from cdmft_lanc_ed_torch.utils import fock as tfock


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


KM_KW = dict(nlat=6, norb=1, nspin=2, nbath=2)


def _km_hloc():
    return tkm.kanemele_cluster_hloc(1.0, 0.3, 0.1)


def test_hbath_basis_from_hloc_matches_jax():
    t = tbath.hbath_basis_from_hloc(_km_hloc(), tpkg.EDConfig(**KM_KW))
    j = jbath.hbath_basis_from_hloc(_km_hloc(), jpkg.EDConfig(**KM_KW))
    assert t.nsym > 0 and np.iscomplexobj(t.basis)
    np.testing.assert_array_equal(t.basis, j.basis)
    np.testing.assert_array_equal(t.init_lambda, j.init_lambda)
    assert tpkg.hbath_basis_from_hloc is tbath.hbath_basis_from_hloc


def test_set_hbath_from_hloc_matches_jax(tmp_path):
    ts = tpkg.EDSolver(tpkg.EDConfig(work_dir=str(tmp_path), **KM_KW),
                       device="cpu")
    js = jpkg.EDSolver(jpkg.EDConfig(work_dir=str(tmp_path), **KM_KW))
    ts.set_hbath_from_hloc(_km_hloc())
    js.set_hbath_from_hloc(_km_hloc())
    np.testing.assert_array_equal(ts.hb.basis, js.hb.basis)
    np.testing.assert_array_equal(ts.hb.init_lambda, js.hb.init_lambda)
    assert ts.get_bath_dimension() == js.get_bath_dimension()


def _bath_array(pkg, cfg):
    hb = pkg.bath.hbath_basis_from_hloc(_km_hloc(), cfg)
    b = pkg.bath.init_dmft_bath(cfg, hb)
    rng = np.random.default_rng(3)
    b.lam = rng.normal(size=b.lam.shape)
    return hb, pkg.bath.pack_dmft_bath(cfg, b)


def test_impose_helpers_match_jax():
    tcfg, jcfg = tpkg.EDConfig(**KM_KW), jpkg.EDConfig(**KM_KW)
    _, tb = _bath_array(tpkg, tcfg)
    _, jb = _bath_array(jpkg, jcfg)
    np.testing.assert_array_equal(tb, jb)
    for ibath in (0, 1):
        np.testing.assert_array_equal(
            tbath.impose_equal_lambda(tcfg, tb, ibath, [0, 2]),
            jbath.impose_equal_lambda(jcfg, jb, ibath, [0, 2]))
        np.testing.assert_array_equal(
            tbath.impose_bath_offset(tcfg, tb, ibath, 0.25),
            jbath.impose_bath_offset(jcfg, jb, ibath, 0.25))


@pytest.mark.parametrize("wdiag,uplo", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_hbath_mask_matches_jax(wdiag, uplo):
    tcfg, jcfg = tpkg.EDConfig(**KM_KW), jpkg.EDConfig(**KM_KW)
    thb, _ = _bath_array(tpkg, tcfg)
    jhb, _ = _bath_array(jpkg, jcfg)
    t = tbath.hbath_mask(tcfg, thb, wdiag=wdiag, uplo=uplo)
    assert t.dtype == bool and t.any()
    np.testing.assert_array_equal(t, jbath.hbath_mask(jcfg, jhb, wdiag=wdiag,
                                                      uplo=uplo))


def _spectra(seed=9):
    """The same random pole/weight spectrum in both packages' stores:
    poles of both signs up to |p| = 3 (beta * p up to 300)."""
    out = []
    for gf_mod in (tgf, jgf):
        spec = gf_mod.GFSpectrum()
        r = np.random.default_rng(seed)
        for istate in range(2):
            for _ in range(2):
                p = r.uniform(-3.0, 3.0, size=7)
                w = r.uniform(0.0, 1.0, size=7) + 1j * r.normal(size=7)
                spec.add_channel((0, 0, 0, 0, 0), istate,
                                 gf_mod.GFChannel(p, w))
        out.append(spec)
    return out


def test_tau_grid_and_evaluate_tau_match_jax():
    cfg_kw = dict(beta=100.0, ltau=257)
    tau = tgf.tau_grid(tpkg.EDConfig(**cfg_kw))
    np.testing.assert_array_equal(tau, jgf.tau_grid(jpkg.EDConfig(**cfg_kw)))
    tspec, jspec = _spectra()
    t = tspec.evaluate_tau((0, 0, 0, 0, 0), tau, 100.0)
    j = jspec.evaluate_tau((0, 0, 0, 0, 0), tau, 100.0)
    assert np.isfinite(t).all() and np.abs(t).max() > 0.0
    np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-12 * np.abs(j).max())
    np.testing.assert_array_equal(
        tspec.evaluate_tau((0, 0, 0, 0, 1), tau, 100.0),
        np.zeros(len(tau)))


@pytest.fixture(scope="module")
def plaquette(tmp_path_factory):
    """The bath-less U=4 plaquette solved by the port (dm_flag)."""
    h = np.zeros((4, 4, 1, 1, 1, 1), np.complex128)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        h[i, j, 0, 0, 0, 0] = h[j, i, 0, 0, 0, 0] = -1.0
    cfg = tpkg.EDConfig(nlat=4, norb=1, nspin=1, nbath=0, uloc=[4.0],
                        lmats=16, lreal=8, dm_flag=True, ed_verbose=0,
                        work_dir=str(tmp_path_factory.mktemp("plaq")))
    s = tpkg.EDSolver(cfg, device="cpu")
    s.init_solver()
    s.solve(np.zeros(0), h)
    return s


def test_evaluate_tau_of_a_solve(plaquette):
    """G(tau) of the solve's spectrum: the port against JAX's function on
    the same poles; G(0) + G(beta) = -1 on the diagonal."""
    cfg = plaquette.cfg
    spec = plaquette.gf.spectrum
    jspec = jgf.GFSpectrum()
    jspec.data = spec.data
    tau = tgf.tau_grid(cfg)
    key = (0, 0, 0, 0, 0)
    t = spec.evaluate_tau(key, tau, cfg.beta)
    np.testing.assert_allclose(t, jspec.evaluate_tau(key, tau, cfg.beta),
                               rtol=1e-12, atol=1e-14)
    assert t[0] + t[-1] == pytest.approx(-1.0, abs=1e-6)


def test_gs_degeneracy_matches_jax():
    rng = np.random.default_rng(4)
    energies = [-1.0, -1.0 + 1e-9, -1.0 + 1e-5, -0.5, -0.2]
    lists = []
    for eig in (teig, jeig):
        sl = eig.StateList()
        for e in energies:
            sl.add(e, rng.normal(size=4), 1, 2, size=10)
        lists.append(sl)
    for thr in (1e-12, 1e-7, 1e-3):
        assert lists[0].gs_degeneracy(thr) == lists[1].gs_degeneracy(thr)
    assert [lists[0].gs_degeneracy(t) for t in (1e-12, 1e-7, 1e-3)] \
        == [1, 2, 3]


def test_entropies_match_jax(plaquette):
    rng = np.random.default_rng(6)
    a = rng.normal(size=(8, 8)) + 1j * rng.normal(size=(8, 8))
    rho = a @ a.conj().T
    rho /= np.trace(rho).real
    assert tobs.von_neumann_entropy(rho) == pytest.approx(
        jobs.von_neumann_entropy(rho), rel=1e-12)
    cdm = plaquette.cluster_dm()
    tcfg = plaquette.cfg
    jcfg = jpkg.EDConfig(nlat=4, norb=1, nspin=1, nbath=0)
    np.testing.assert_array_equal(tobs._sites_mask(tcfg, [0, 2]),
                                  jobs._sites_mask(jcfg, [0, 2]))
    for sites in ([0], [1, 2]):
        t = tobs.site_entanglement_entropy(tcfg, cdm, sites)
        assert t > 0.0
        assert t == pytest.approx(
            jobs.site_entanglement_entropy(jcfg, cdm, sites), rel=1e-12)
    t = tobs.mutual_information(tcfg, cdm, 0, 3)
    assert t == pytest.approx(jobs.mutual_information(jcfg, cdm, 0, 3),
                              rel=1e-12)


def test_bjoin_and_state_index_match_jax():
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, size=(5, 7, 12))
    t = tfock.bjoin(bits)
    np.testing.assert_array_equal(t, jfock.bjoin(bits))
    states = np.asarray(tfock.sector_states(12, 6))
    np.testing.assert_array_equal(tfock.bdecomp(t.ravel(), 12),
                                  bits.reshape(-1, 12))
    pick = rng.choice(states, size=50)
    idx = tfock.state_index(states, pick)
    np.testing.assert_array_equal(idx, jfock.state_index(states, pick))
    np.testing.assert_array_equal(states[idx], pick)
