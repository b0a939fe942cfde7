"""The reference side of the BHZ chain cluster with general baths
(``"model": "bhz_chain"``): the plain problem of one solve.  Its program
side is ``models/bhz_chain.py``.

The model is the one of the upstream driver ``drivers/cdn_bhz_1d.f90``:
an Nx-site cluster of the BHZ chain, two orbitals and two spins per site,
spin-diagonal but complex::

    on site:           Mh σz
    bond i -> i+1:     -ts σz + s·i lam/2 σx    (s = +1 for spin up, -1 down)

and baths of the general type, each a copy of the cluster's levels whose
Hamiltonian is Σ_k lambda_b,k B_k over the unit-amplitude BHZ matrices B_k
(Mh, ts, lam: ``basis``), hybridised level by level with the impurity.

Configuration keys read: ``cluster`` {nx, mh, ts, lam}, ``ed`` {uloc, ust,
jh, xmu, beta, lmats, lanc_ngfiter} and the bath of the solve {"lambda":
[[mh_b, ts_b, lam_b]], "v": [[v_b,lso]]}: v_b,lso hybridises impurity
level (site, orbital) of spin s with its copy in bath b (lso = orb +
site·norb + s·nlat·norb).

Levels of one spin: impurity (site, orbital) at site·2 + orbital, then
bath b's copy at 2·nlat·(b+1) + site·2 + orbital.  Interaction on each
site: U (n_o↑ - 1/2)(n_o↓ - 1/2) per orbital, Ust between opposite spins
of different orbitals, Ust - Jh between equal spins (each in the
half-filling form), less the constant nlat·Σ_{o<o'} (2 Ust - Jh)/4 by
which that form differs from the one the upstream code diagonalises.

Departures from the upstream driver's Hamiltonian: none in the terms
that the configuration switches on.  The spin-flip and pair-hopping
terms (Jx, Jp) are not modelled: the configuration sets Jh = 0 and the
upstream defaults leave Jx = Jp = 0.  The cluster is open: the bond
that closes the chain across clusters belongs to the lattice H(k), not
to the impurity problem.
"""
from __future__ import annotations

import numpy as np

from reference.cluster_ed import Problem

SX = np.array([[0, 1], [1, 0]], dtype=np.complex128)
SZ = np.array([[1, 0], [0, -1]], dtype=np.complex128)
NORB = 2


def cluster(nx: int, mh: float, ts: float, lam: float) -> np.ndarray:
    """[nlat, nlat, 2, 2, 2, 2] BHZ chain cluster (site, site, spin, spin,
    orbital, orbital): Mh σz on each site, the bond i -> i+1 of spin s is
    -ts σz ± i lam/2 σx (+ for spin up)."""
    h = np.zeros((nx, nx, 2, 2, NORB, NORB), np.complex128)
    for s in range(2):
        tx = -ts * SZ + 0.5 * (1.0 if s == 0 else -1.0) * 1j * lam * SX
        for i in range(nx):
            h[i, i, s, s] += mh * SZ
            if i + 1 < nx:
                h[i + 1, i, s, s] += tx
                h[i, i + 1, s, s] += tx.conj().T
    return h


def basis(nx: int) -> np.ndarray:
    """[3, nlat, nlat, 2, 2, 2, 2]: the unit-amplitude Mh, ts, lam parts."""
    return np.stack([cluster(nx, 1.0, 0.0, 0.0), cluster(nx, 0.0, 1.0, 0.0),
                     cluster(nx, 0.0, 0.0, 1.0)])


def _block(h: np.ndarray, s: int) -> np.ndarray:
    """[nlat, nlat, 2, 2, norb, norb] -> [nlat·norb, nlat·norb] of spin s."""
    nlat, norb = h.shape[0], h.shape[4]
    return h[:, :, s, s].transpose(0, 2, 1, 3).reshape(nlat * norb,
                                                       nlat * norb)


def one_body(config: dict, bath: dict) -> np.ndarray:
    """[2, Ns, Ns] one-body matrix of each spin: the cluster (less xmu),
    each bath's copy and the hybridisations."""
    cl = config["cluster"]
    nx = cl["nx"]
    nimp = nx * NORB
    hloc = cluster(nx, cl["mh"], cl["ts"], cl["lam"])
    lam, v = np.asarray(bath["lambda"]), np.asarray(bath["v"])
    nbath = len(lam)
    ns = nimp * (nbath + 1)
    hb = np.einsum("bk,k...->b...", lam, basis(nx))
    xmu = float(config["ed"].get("xmu", 0.0))
    hs = np.zeros((2, ns, ns), np.complex128)
    for s in range(2):
        hs[s, :nimp, :nimp] = _block(hloc, s) - xmu * np.eye(nimp)
        for b in range(nbath):
            copy = nimp * (b + 1)
            hs[s, copy:copy + nimp, copy:copy + nimp] = _block(hb[b], s)
            for a in range(nimp):
                vb = v[b, a + s * nimp]
                hs[s, copy + a, a] = hs[s, a, copy + a] = vb
    return hs


def interaction(config: dict):
    """(W↑↓, W=, shift) on the impurity levels of an nx-site cluster."""
    ed, nx = config["ed"], config["cluster"]["nx"]
    nimp = nx * NORB
    u, ust = ed["uloc"], float(ed.get("ust", 0.0))
    jh = float(ed.get("jh", 0.0))
    w_updw = np.zeros((nimp, nimp))
    w_same = np.zeros((nimp, nimp))
    for i in range(nx):
        for o in range(NORB):
            a = i * NORB + o
            w_updw[a, a] = u[o]
            for o2 in range(NORB):
                if o2 != o:
                    w_updw[a, i * NORB + o2] = ust
                    if o2 > o:
                        w_same[a, i * NORB + o2] = ust - jh
    npairs = NORB * (NORB - 1) // 2
    return w_updw, w_same, -nx * npairs * (2 * ust - jh) / 4


def problem(config: dict, bath: dict) -> Problem:
    """The plain problem of the solve at ``bath``."""
    ed = config["ed"]
    w_updw, w_same, shift = interaction(config)
    return Problem(h=one_body(config, bath),
                   nimp=config["cluster"]["nx"] * NORB,
                   w_updw=w_updw, w_same=w_same, half_filling_form=True,
                   shift=shift, beta=float(ed.get("beta", 1000.0)),
                   lmats=int(ed["lmats"]),
                   ngfiter=int(ed.get("lanc_ngfiter", 200)))
