"""A small complex BHZ case shared by the port's parity tests.

The single-site BHZ configuration of tests/test_bhz_general_bath.py:13-27
(Norb=2, Nspin=2, 2 general baths: Ns=6) has no bonds, so every term of
its Hamiltonian is real.  This case adds a time-reversal-symmetric complex
on-site orbital mixing, +a sigma_y for spin up and -a sigma_y (its complex
conjugate) for spin down, to the impurity and, as a fourth symmetry term,
to the bath basis.  Every sector Hamiltonian is then complex, with
H_dw = conj(H_up) as in the BHZ chain, and both batched and serial
Lanczos sectors occur at lanc_dim_threshold=16.
"""
import importlib

import numpy as np

KW = dict(nlat=1, norb=2, nspin=2, nbath=2, uloc=[1.0, 1.0], ust=0.5,
          jh=0.1, beta=100.0, lmats=32, lreal=16, lanc_ngfiter=48,
          bath_type="general", ed_verbose=0, lanc_dim_threshold=16,
          lanc_nstates_sector=1, dm_flag=True)
MODEL = dict(mh=0.5, ts=0.25, lam=0.3)
SOC = 0.2           # amplitude of the complex on-site term


def _soc(bhz):
    h = np.zeros((1, 1, 2, 2, 2, 2), np.complex128)
    h[0, 0, 0, 0] = bhz.SY
    h[0, 0, 1, 1] = -bhz.SY
    return h


def model(bhz):
    """(hloc, bath basis [4, ...], lambdas [Nbath, 4]) from a package's
    ``models.bhz`` module."""
    soc = _soc(bhz)
    hloc = bhz.bhz_cluster_hloc(1, 1, **MODEL) + SOC * soc
    basis, lam0 = bhz.bhz_bath_basis(1, 1, **MODEL)
    basis = np.concatenate([basis, soc[None]])
    lams = np.tile(np.append(lam0, SOC), (KW["nbath"], 1)) \
        * np.linspace(0.5, 1.5, KW["nbath"])[:, None]
    return hloc, basis, lams


def lattice(bhz, nk=4):
    """(hk [Nk^2, Nlso, Nlso], hloc) of the tiled single-site model."""
    hk, _ = bhz.bhz_cluster_hk(1, 1, nk, **MODEL)
    hloc, _, _ = model(bhz)
    soc = _soc(bhz)[0, 0]
    # lso order: orbital fastest, then spin (nnn2lso with Nlat=1)
    soc_lso = np.zeros((4, 4), np.complex128)
    for s in range(2):
        soc_lso[2 * s:2 * s + 2, 2 * s:2 * s + 2] = soc[s, s]
    return hk + SOC * soc_lso[None], hloc


def sector_ops(pkg, cfg, keys):
    """Sector operators {(nup, ndw): op} of package ``pkg`` at the
    initial bath."""
    bhz = importlib.import_module(pkg.__name__ + ".models.bhz")
    sh = importlib.import_module(pkg.__name__ + ".ops.sector_ham")
    hloc, basis, lams = model(bhz)
    hb = pkg.bath.set_hbath(basis, lams, cfg)
    b = pkg.bath.init_dmft_bath(cfg, hb)
    hrec = pkg.bath.bath_h_rec(cfg, hb, b)
    dhyb = pkg.bath.diag_hybr_of(cfg, b)
    return {k: sh.build_sector_operator(cfg, hloc, hrec, dhyb, *k)
            for k in keys}
