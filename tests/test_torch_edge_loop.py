"""One iteration of the BHZ edge driver's loop body, the port against the
JAX package.

At Nx=2, Ly=4, lrsym (Nineq=2: the edge and the bulk layer), one replica
bath (Ns=8, complex sectors): the port's ``cdn_bhz_2d_edge.main`` against
the same steps through the JAX modules (LatticeSolver, the ribbon G_loc,
the per-layer Weiss fields, the fit).  egs, the per-layer Sigma and the
Weiss fields to 1e-10.  The fit is driven to its minimum (cg_ftol=1e-12)
at beta=10: at beta=50 the edge layer's chi^2 has no minimum at this depth
(its bath levels run off, to -30 in the port and -43 in the JAX package).
At beta=10 both packages stop where 500 and 5000 CG iterations stop, on
"precision loss" in a flat valley: the bulk layer's baths lie 2.7e-4
apart, the hybridisation they fit 4.6e-6 (relative).  So the fitted baths
are held to 1e-3 and their Delta(iw) on the fit grid to 1e-5.  To stay
inside the test budget lmats and lanc_ngfiter are 16 and the sweep is cut
to the half-filled (4,4) sector of each cluster by the reference's own
mechanism (ed_sectors, a sectors_list restart per cluster), on both sides.
"""
import dataclasses
import os

import numpy as np
import pytest
import threadpoolctl
import torch

import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_tpu import lattice as jlat
from cdmft_lanc_ed_tpu.lattice_solver import LatticeSolver as JLattice
from cdmft_lanc_ed_tpu.models import bhz as jbhz
from cdmft_lanc_ed_torch.drivers import cdn_bhz_2d_edge


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One BLAS and one intra-op thread: the suite runs in several worker
    processes at once."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(nthreads)


NX, LY, NK = 2, 4, 8
MODEL = dict(mh=1.0, ts=0.25, lam=0.3)
EDGE_INPUT = """NBATH=1
ULOC=2.0,2.0
UST=0.5
BETA=10
LMATS=16
LREAL=16
LFIT=16
NLOOP=1
LANC_NGFITER=16
CG_FTOL=1e-12
ED_VERBOSE=0
ED_SECTORS=T
ED_SECTORS_SHIFT=0
WORK_DIR={}
"""


def _edge_dir(path):
    os.makedirs(path)
    with open(path / "input.conf", "w") as fh:
        fh.write(EDGE_INPUT.format(path))
    for ineq in (1, 2):
        with open(path / f"sectors_list_ineq{ineq:04d}.restart", "w") as fh:
            fh.write(" 4 4\n")
    return str(path / "input.conf")


def _jax_edge_iteration(conf):
    """The loop body of drivers/cdn_bhz_2d_edge.py:89-110, once, through
    the JAX modules."""
    nineq = LY // 2
    cfg = jpkg.read_input(conf, nlat=NX, norb=2, nspin=2,
                          bath_type="replica")
    hk, _ = jbhz.bhz_chain_hk(NX, LY, NK, **MODEL)
    hloc_layer = jbhz.bhz_cluster_hloc(NX, 1, **MODEL)
    hloc_ineq = np.broadcast_to(hloc_layer,
                                (nineq,) + hloc_layer.shape).copy()
    ls = JLattice(cfg, nineq=nineq)
    basis, lam0 = jbhz.bhz_bath_basis(NX, 1, **MODEL)
    ls.set_hbath(basis, np.tile(lam0, (nineq, cfg.nbath, 1)))
    baths = ls.init_solver()
    ls.solve(baths, hloc_ineq)
    smats = ls.sigma_matsubara()
    big = np.zeros((NX * LY, NX * LY) + smats.shape[3:], np.complex128)
    for layer in range(LY):
        sl = slice(layer * NX, (layer + 1) * NX)
        big[sl, sl] = smats[layer if layer < nineq else LY - layer - 1]
    gloc = jlat.dmft_gloc_matsubara(dataclasses.replace(cfg, nlat=NX * LY),
                                    hk, big)
    weiss = np.empty_like(smats)
    for ineq in range(nineq):
        sl = slice(ineq * NX, (ineq + 1) * NX)
        weiss[ineq] = jlat.dmft_self_consistency(
            cfg, gloc[sl, sl], smats[ineq], hloc_ineq[ineq],
            scheme=cfg.cg_scheme)
    return smats, weiss, ls.fit(weiss, baths, hloc_ineq=hloc_ineq), ls.egs()


def test_edge_iteration_matches_jax(tmp_path, monkeypatch):
    # the JAX side on its split-plane kit, the algorithm the port carries
    monkeypatch.setenv("CDMFT_SPLIT_BACKEND", "1")
    js, jw, jb, jegs = _jax_edge_iteration(_edge_dir(tmp_path / "jax"))
    res = cdn_bhz_2d_edge.main(["--input", _edge_dir(tmp_path / "torch"),
                                "--nx", str(NX), "--ly", str(LY), "--nk",
                                str(NK), "--cpu"])
    assert res["solver"].nineq == 2 and len(res["errors"]) == 1
    np.testing.assert_allclose(res["egs"], jegs, rtol=0, atol=1e-10)
    # both clusters start from one bath and one Hloc
    assert abs(res["egs"][0] - res["egs"][1]) < 1e-10
    scale = np.abs(js).max()
    np.testing.assert_allclose(res["smats"], js, rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(res["weiss"], jw, rtol=0,
                               atol=1e-10 * np.abs(jw).max())
    # the ribbon G_loc reaches the layers differently
    assert np.abs(res["weiss"][0] - res["weiss"][1]).max() \
        > 1e-6 * np.abs(jw).max()
    # the fit: scipy's CG stops on "precision loss" in a flat valley, at
    # points 2.7e-4 apart in the bulk layer's bath (the same points at 500
    # and 5000 iterations); the hybridisation it fits agrees to 4.6e-6
    ls = res["solver"]
    for ineq, s in enumerate(ls.solvers):
        z = 1j * np.pi / s.cfg.beta * (2 * np.arange(s.cfg.lfit) + 1)
        d_t, d_j = (tpkg.delta_bath(s.cfg, s.hb, tpkg.unpack_dmft_bath(
            s.cfg, b[ineq]), z, device="cpu") for b in (res["baths"], jb))
        assert np.abs(d_t - d_j).max() <= 1e-5 * np.abs(d_j).max()
    np.testing.assert_allclose(res["baths"], jb, rtol=0, atol=1e-3)
    t = res["timings"][0]
    assert len(t["solve_s"]) == 2 and {"gloc_s", "weiss_s", "fit_s"} <= set(t)
