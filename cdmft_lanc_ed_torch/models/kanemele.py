"""Kane-Mele model on the honeycomb lattice, 6-site hexagon cluster.

Copy of the JAX package's ``models/kanemele.py``; counterpart of the
reference's drivers/cdn_kanemele.f90 (Nlat=6, Norb=1,
Nspin=2).  Instead of transcribing the reference's hand-coded 6x6 hopping
matrices, the Hamiltonian is derived from the honeycomb geometry:

* 6-site hexagonal cluster (ring 0-1-2-3-4-5, alternating A/B sublattice);
  hexagon centres tile the plane on a triangular superlattice with
  A1 = (3/2, +sqrt(3)/2), A2 = (3/2, -sqrt(3)/2) (bond length = 1);
* NN bonds (|d| = 1): hopping t (+ Semenoff mass +/-M on A/B);
* NNN bonds (|d| = sqrt(3)): Kane-Mele SOC i*lam*nu*s_z with the chirality
  nu = sign of the cross product of the two legs i->k->j.

Self-checks (tests): hermiticity, graphene spectrum at lam=M=0, the known
Kane-Mele gap 6*sqrt(3)*lam at K for M=0.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..lattice import build_kgrid
from ..utils.reshape import nnn2lso

# hexagon ring sites (bond length 1, centre at origin);
# even index = sublattice A (+M), odd = B (-M)
_ANG = np.pi / 3.0 * np.arange(6)
POSITIONS = np.stack([np.cos(_ANG), np.sin(_ANG)], axis=1)
SUBLATTICE = np.array([+1, -1, +1, -1, +1, -1])
# superlattice vectors: neighbouring hexagon centres sit at distance 3
# (sqrt(3) x sqrt(3) R30 supercell, 3 honeycomb unit cells per hexagon);
# for this ring orientation (vertices at angles 0, 60, ...): A1 = (3, 0),
# A2 = 3 (cos 60, sin 60) — verified by the bond-count self-check in tests
SUPERCELL = 3.0 * np.array([[1.0, 0.0],
                            [np.cos(np.pi / 3), np.sin(np.pi / 3)]])


def _all_bonds(tol: float = 1e-8):
    """Enumerate NN (d=1) and NNN (d=sqrt(3)) bonds i -> j + R over the
    3x3 neighbourhood of supercells.  Returns lists of
    (i, j, cell (n1,n2), kind, nu) with nu the SOC chirality for NNN."""
    bonds = []
    for n1 in (-1, 0, 1):
        for n2 in (-1, 0, 1):
            shift = n1 * SUPERCELL[0] + n2 * SUPERCELL[1]
            for i in range(6):
                for j in range(6):
                    d = POSITIONS[j] + shift - POSITIONS[i]
                    r = np.hypot(*d)
                    if abs(r - 1.0) < tol:
                        bonds.append((i, j, (n1, n2), "nn", 0))
                    elif abs(r - np.sqrt(3)) < tol:
                        # chirality: unique common NN k of i and j
                        nu = 0
                        for m1 in (-1, 0, 1):
                            for m2 in (-1, 0, 1):
                                s2 = m1 * SUPERCELL[0] + m2 * SUPERCELL[1]
                                for k in range(6):
                                    pk = POSITIONS[k] + s2
                                    d1 = pk - POSITIONS[i]
                                    d2 = POSITIONS[j] + shift - pk
                                    if abs(np.hypot(*d1) - 1) < tol and \
                                            abs(np.hypot(*d2) - 1) < tol:
                                        nu = int(np.sign(
                                            d1[0] * d2[1] - d1[1] * d2[0]))
                        bonds.append((i, j, (n1, n2), "nnn", nu))
    return bonds


_BONDS = _all_bonds()


def kanemele_hk_at(kpoint: np.ndarray, t: float, mh: float,
                   lam: float) -> np.ndarray:
    """H(k) [6,6,2,2,1,1] in nnn form; kpoint in Cartesian coordinates of
    the superlattice reciprocal space (phases e^{i k . R})."""
    h = np.zeros((6, 6, 2, 2, 1, 1), np.complex128)
    for s, ssign in ((0, +1), (1, -1)):
        for i in range(6):
            h[i, i, s, s, 0, 0] += mh * SUBLATTICE[i]
        for (i, j, (n1, n2), kind, nu) in _BONDS:
            rvec = n1 * SUPERCELL[0] + n2 * SUPERCELL[1]
            ph = np.exp(1j * (kpoint[0] * rvec[0] + kpoint[1] * rvec[1]))
            if kind == "nn":
                h[i, j, s, s, 0, 0] += t * ph
            else:
                h[i, j, s, s, 0, 0] += 1j * lam * nu * ssign * ph
    return h


def kanemele_cluster_hloc(t: float, mh: float, lam: float) -> np.ndarray:
    """Intra-cluster part (R = 0 bonds only)."""
    h = np.zeros((6, 6, 2, 2, 1, 1), np.complex128)
    for s, ssign in ((0, +1), (1, -1)):
        for i in range(6):
            h[i, i, s, s, 0, 0] += mh * SUBLATTICE[i]
        for (i, j, (n1, n2), kind, nu) in _BONDS:
            if (n1, n2) != (0, 0):
                continue
            if kind == "nn":
                h[i, j, s, s, 0, 0] += t
            else:
                h[i, j, s, s, 0, 0] += 1j * lam * nu * ssign
    return h


def kanemele_cluster_hk(nk: int, t: float, mh: float, lam: float
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(Hk [nk^2, 12, 12] lso, Hloc nnn) on a uniform superlattice BZ grid."""
    # reciprocal superlattice vectors: B satisfies B @ SUPERCELL.T = 2 pi I
    b = 2 * np.pi * np.linalg.inv(SUPERCELL).T
    frac = build_kgrid(nk, 2) / (2 * np.pi)       # fractional coords
    hks = []
    hloc = kanemele_cluster_hloc(t, mh, lam)
    for f in frac:
        k = f[0] * b[0] + f[1] * b[1]
        hks.append(nnn2lso(kanemele_hk_at(k, t, mh, lam), 6, 2, 1))
    return np.stack(hks), hloc
