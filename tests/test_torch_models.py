"""The port's model modules against the JAX package, and one Kane-Mele solve.

* Kane-Mele (bonds, supercell, positions, H(k) at random k points, the
  cluster Hloc and H(k) on a grid), kagome, SG77, SSH and
  ``hubbard.bethe_hk``: every array equal to JAX's to 1e-15 (they are
  copies of host numpy code, so they agree exactly).
* One solve of the bath-less Kane-Mele hexagon (Nlat=6, Norb=1, Nspin=2:
  Ns=6, every sector complex through the spin-orbit term) against the JAX
  package at the tolerances tests/test_torch_bhz.py holds the complex
  path to: egs, dens and docc to 1e-9, Sigma(iw) to 1e-9 relative under
  "complex128" and 5e-5 under "mixed", G0(iw) to 1e-12.  The JAX side
  runs its split-plane kit (CDMFT_SPLIT_BACKEND=1).  The density matrices
  are left out here: the cluster DM of six sites has 4096² entries, and
  printing it (dm_flag) takes either package ~40 s on the CPU.
"""
import numpy as np
import pytest
import threadpoolctl
import torch

import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_tpu.models import hubbard as jhub
from cdmft_lanc_ed_tpu.models import kagome as jkag
from cdmft_lanc_ed_tpu.models import kanemele as jkm
from cdmft_lanc_ed_tpu.models import sg77 as jsg
from cdmft_lanc_ed_tpu.models import ssh as jssh
from cdmft_lanc_ed_torch.models import hubbard as thub
from cdmft_lanc_ed_torch.models import kagome as tkag
from cdmft_lanc_ed_torch.models import kanemele as tkm
from cdmft_lanc_ed_torch.models import sg77 as tsg
from cdmft_lanc_ed_torch.models import ssh as tssh
from cdmft_lanc_ed_torch.ops import split as tsplit


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


ATOL = 1e-15


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def _kpoints(n, seed=11):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, size=(n, 2))


def test_kanemele_matches_jax():
    assert tkm._all_bonds() == jkm._all_bonds() == jkm._BONDS
    _same(tkm.SUPERCELL, jkm.SUPERCELL)
    _same(tkm.POSITIONS, jkm.POSITIONS)
    _same(tkm.SUBLATTICE, jkm.SUBLATTICE)
    for k in _kpoints(5):
        _same(tkm.kanemele_hk_at(k, 1.0, 0.2, 0.1),
              jkm.kanemele_hk_at(k, 1.0, 0.2, 0.1))
    _same(tkm.kanemele_cluster_hloc(1.0, 0.2, 0.1),
          jkm.kanemele_cluster_hloc(1.0, 0.2, 0.1))
    for a, b in zip(tkm.kanemele_cluster_hk(4, 1.0, 0.2, 0.1),
                    jkm.kanemele_cluster_hk(4, 1.0, 0.2, 0.1)):
        _same(a, b)


@pytest.mark.parametrize("nspin", [1, 2])
def test_kagome_matches_jax(nspin):
    assert tkag._bonds() == jkag._BONDS
    _same(tkag.SUPERCELL, jkag.SUPERCELL)
    for k in _kpoints(3):
        _same(tkag.kagome_hk_at(k, 0.7, nspin),
              jkag.kagome_hk_at(k, 0.7, nspin))
    _same(tkag.kagome_cluster_hloc(0.7, nspin),
          jkag.kagome_cluster_hloc(0.7, nspin))
    for a, b in zip(tkag.kagome_cluster_hk(4, 0.7, nspin),
                    jkag.kagome_cluster_hk(4, 0.7, nspin)):
        _same(a, b)


def test_sg77_matches_jax():
    ts = 0.8
    _same(tsg.sg77_cluster_hloc(2, ts), jsg.sg77_cluster_hloc(2, ts))
    k3 = np.random.default_rng(5).uniform(-np.pi, np.pi, size=(3, 3))
    for k in k3:
        _same(tsg.sg77_hk_at(k, 2, ts), jsg.sg77_hk_at(k, 2, ts))
    for a, b in zip(tsg.sg77_cluster_hk(2, 3, ts),
                    jsg.sg77_cluster_hk(2, 3, ts)):
        _same(a, b)


def test_ssh_and_bethe_match_jax():
    _same(tssh.ssh_cluster_hloc(2, 1.0, 0.3), jssh.ssh_cluster_hloc(2, 1.0,
                                                                    0.3))
    for a, b in zip(tssh.ssh_cluster_hk(2, 16, 1.0, 0.3),
                    jssh.ssh_cluster_hk(2, 16, 1.0, 0.3)):
        _same(a, b)
    for a, b in zip(thub.bethe_hk(64, 2.0, nspin=2),
                    jhub.bethe_hk(64, 2.0, nspin=2)):
        _same(a, b)


# The bath-less Kane-Mele hexagon at the model parameters of
# drivers/cdn_kanemele.py (t=1, M=0, lambda=0.1)
KM = dict(t=1.0, mh=0.0, lam=0.1)
KM_KW = dict(nlat=6, norb=1, nspin=2, nbath=0, uloc=[2.0], beta=100.0,
             lmats=32, lreal=16, lanc_ngfiter=48, lanc_dim_threshold=16,
             lanc_nstates_sector=1, ed_verbose=0)


def _solve(pkg, km, workdir, prec, **solver_kw):
    cfg = pkg.EDConfig(ed_precision=prec, work_dir=str(workdir), **KM_KW)
    s = pkg.EDSolver(cfg, **solver_kw)
    s.init_solver()
    s.solve(np.zeros(0), km.kanemele_cluster_hloc(**KM))
    return s


@pytest.fixture(scope="module")
def jax_km(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        # the JAX side on its split-plane kit, the algorithm the port has
        mp.setenv("CDMFT_SPLIT_BACKEND", "1")
        return _solve(jpkg, jkm, tmp_path_factory.mktemp("jax"),
                      "complex128")


@pytest.mark.parametrize("prec,sig_rtol", [("complex128", 1e-9),
                                           ("mixed", 5e-5)])
def test_kanemele_solve_matches_jax(tmp_path, jax_km, prec, sig_rtol):
    s = _solve(tpkg, tkm, tmp_path, prec, device="cpu")
    op = s._sector_builder()(3, 3)
    assert not tsplit.op_is_real(op)                  # the complex path
    js = jax_km
    assert s.egs == pytest.approx(js.egs, abs=1e-9)
    np.testing.assert_allclose(s.dens(), js.dens(), atol=1e-9)
    np.testing.assert_allclose(s.docc(), js.docc(), atol=1e-9)
    sig, sig_j = s.sigma_matsubara(), js.sigma_matsubara()
    np.testing.assert_allclose(sig, sig_j, rtol=sig_rtol,
                               atol=sig_rtol * np.abs(sig_j).max())
    np.testing.assert_allclose(s.g0imp_matsubara(), js.g0imp_matsubara(),
                               rtol=1e-12, atol=1e-12)
    assert s.gf.spectrum.symmetric is False           # the 4-channel scheme
