"""The reference side of the BHZ chain cluster with general baths
(``"model": "bhz_general"``): two orbitals and two spins per site, a
complex cluster Hamiltonian diagonal in spin, and baths that copy the
cluster with their own BHZ parameters.

Configuration keys read: ``cluster`` {nx, mh, ts, lam} (an open chain of
nx sites), ``ed`` {uloc, ust, jh, xmu, beta, lmats, lanc_ngfiter} and the
bath of the solve {"lambda": [[mh_b, ts_b, lam_b]], "v": [[v_b,lso]]}:
bath b's Hamiltonian is Σ_k lambda_b,k B_k over the unit-amplitude BHZ
matrices B_k, and v_b,lso hybridises impurity level (site, orbital) of
spin s with its copy in bath b (lso = orb + site·norb + s·nlat·norb).

Levels of one spin: impurity (site, orbital) at site·2 + orbital, then
bath b's copy at 2·nlat·(b+1) + site·2 + orbital.  Interaction on each
site: U (n_o↑ - 1/2)(n_o↓ - 1/2) per orbital, Ust between opposite spins
of different orbitals, Ust - Jh between equal spins, less the constant
nlat·Σ_{o<o'} (2 Ust - Jh)/4 that the source code's half-filling form
leaves out.
"""
from __future__ import annotations

import numpy as np

from reference.cluster_ed import Problem

SX = np.array([[0, 1], [1, 0]], dtype=np.complex128)
SZ = np.array([[1, 0], [0, -1]], dtype=np.complex128)


def cluster(nx: int, mh: float, ts: float, lam: float) -> np.ndarray:
    """[nlat, nlat, 2, 2, 2, 2] BHZ chain cluster: Mh σz on each site,
    the bond i -> i+1 of spin s is -ts σz ± i lam/2 σx (+ for spin up)."""
    h = np.zeros((nx, nx, 2, 2, 2, 2), np.complex128)
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


def problem(config: dict, bath: dict) -> Problem:
    ed, cl = config["ed"], config["cluster"]
    nx, norb = cl["nx"], 2
    nimp = nx * norb
    hloc = cluster(nx, cl["mh"], cl["ts"], cl["lam"])
    lam, v = np.asarray(bath["lambda"]), np.asarray(bath["v"])
    nbath = len(lam)
    ns = nimp * (nbath + 1)
    hb = np.einsum("bk,k...->b...", lam, basis(nx))
    hs = np.zeros((2, ns, ns), np.complex128)
    for s in range(2):
        hs[s, :nimp, :nimp] = _block(hloc, s) \
            - float(ed.get("xmu", 0.0)) * np.eye(nimp)
        for b in range(nbath):
            copy = slice(nimp * (b + 1), nimp * (b + 2))
            hs[s, copy, copy] = _block(hb[b], s)
            for i in range(nx):
                for o in range(norb):
                    a = i * norb + o
                    vb = v[b, o + i * norb + s * nx * norb]
                    hs[s, nimp * (b + 1) + a, a] = vb
                    hs[s, a, nimp * (b + 1) + a] = vb
    u, ust, jh = ed["uloc"], float(ed.get("ust", 0.0)), \
        float(ed.get("jh", 0.0))
    w_updw = np.zeros((nimp, nimp))
    w_same = np.zeros((nimp, nimp))
    for i in range(nx):
        for o in range(norb):
            a = i * norb + o
            w_updw[a, a] = u[o]
            for o2 in range(norb):
                if o2 != o:
                    w_updw[a, i * norb + o2] = ust
                    if o2 > o:
                        w_same[a, i * norb + o2] = ust - jh
    npairs = norb * (norb - 1) // 2
    return Problem(h=hs, nimp=nimp, w_updw=w_updw, w_same=w_same,
                   half_filling_form=True,
                   shift=-nx * npairs * (2 * ust - jh) / 4,
                   beta=float(ed.get("beta", 1000.0)),
                   lmats=int(ed["lmats"]),
                   ngfiter=int(ed.get("lanc_ngfiter", 200)))
