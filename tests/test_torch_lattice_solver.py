"""The port's LatticeSolver (real-space CDMFT over inequivalent clusters)
against the JAX package, on the JAX suite's case
(tests/test_lattice_solver.py:9-40): two inequivalent single-site clusters
with U=2 and U=6 and two baths each.  egs, dens, docc, Sigma, the energies
and G to 1e-10, the fitted baths to 1e-7, the per-cluster file suffixes
and the printed Sigma read back.  The BHZ edge driver's loop body is in
tests/test_torch_edge_loop.py.
"""
import os

import numpy as np
import pytest
import threadpoolctl
import torch

import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_tpu.lattice_solver import LatticeSolver as JLattice
from cdmft_lanc_ed_torch.lattice_solver import LatticeSolver as TLattice


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One BLAS and one intra-op thread: the suite runs in several worker
    processes at once."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(nthreads)


KW = dict(nlat=1, norb=1, nspin=1, nbath=2, beta=20.0, lmats=32, lreal=16,
          lanc_ngfiter=32, ed_verbose=0)


def _two_clusters(pkg, cls, workdir, **dev):
    os.makedirs(workdir)
    cfg = pkg.EDConfig(work_dir=str(workdir), **KW)
    ls = cls(cfg, nineq=2, uloc_ii=[[2.0], [6.0]], **dev)
    ls.set_hbath(np.ones((1, 1, 1, 1, 1, 1, 1)), np.array([[0.5], [-0.5]]))
    baths = ls.init_solver()
    hloc = np.zeros((1, 1, 1, 1, 1, 1))
    ls.solve(baths, hloc)
    new_baths = ls.fit(ls.gimp_matsubara(), baths, hloc_ineq=hloc)
    return ls, baths, new_baths


def test_two_clusters_match_jax(tmp_path):
    jls, jb0, jb = _two_clusters(jpkg, JLattice, tmp_path / "jax")
    tls, tb0, tb = _two_clusters(tpkg, TLattice, tmp_path / "torch",
                                 device="cpu")
    np.testing.assert_array_equal(tb0, jb0)
    np.testing.assert_allclose(tls.egs(), jls.egs(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tls.dens(), jls.dens(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tls.docc(), jls.docc(), rtol=0, atol=1e-10)
    for getter in ("sigma_matsubara", "sigma_realaxis", "gimp_matsubara"):
        np.testing.assert_allclose(getattr(tls, getter)(),
                                   getattr(jls, getter)(), rtol=0,
                                   atol=1e-10)
    np.testing.assert_allclose(tls.eimp(), jls.eimp(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tls.doubles(), jls.doubles(), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-7)
    assert tls.docc()[1, 0, 0] < tls.docc()[0, 0, 0] - 0.02
    assert len(tls.solve_seconds) == 2
    for ineq in (1, 2):
        assert (tmp_path / "torch" / f"hamiltonian_ineq{ineq:04d}.used"
                ).exists()
    # the printed Sigma of each cluster reads back into its solver
    np.testing.assert_array_equal(tls.read_impsigma(),
                                  tls.sigma_matsubara())


def test_per_cluster_settings(tmp_path):
    """uloc_ii and xmu_ii reach each cluster's configuration (the input
    one is left as it was), the clusters' files carry their suffix, and a
    shared 6-axis Hloc is broadcast to every cluster."""
    cfg = tpkg.EDConfig(work_dir=str(tmp_path), **dict(KW, nbath=1))
    ls = TLattice(cfg, nineq=2, uloc_ii=[[2.0], [6.0]], xmu_ii=[0.2, -0.2],
                  device="cpu")
    assert [s.cfg.xmu for s in ls.solvers] == [0.2, -0.2]
    assert [s.cfg.uloc for s in ls.solvers] == [[2.0], [6.0]]
    assert [s.cfg.ed_file_suffix for s in ls.solvers] == ["_ineq0001",
                                                          "_ineq0002"]
    assert cfg.xmu == 0.0 and cfg.ed_file_suffix == ""
    ls.set_hbath(np.ones((1, 1, 1, 1, 1, 1, 1)), np.array([[0.5]]))
    ls.solve(ls.init_solver(), np.zeros((1, 1, 1, 1, 1, 1)))
    assert ls.egs()[0] != ls.egs()[1]
    dens = ls.dens().ravel()
    assert dens[0] > 1.0 > dens[1]      # mu above / below half filling
    for ineq in (1, 2):
        assert (tmp_path / f"state_list_ineq{ineq:04d}.ed").exists()
