"""Kagome lattice, 3-site (one triangle) cluster.

Copy of the JAX package's ``models/kagome.py``; counterpart of the
reference's drivers/cdn_kagome.f90 (Nlat=3, Norb=1).
Derived from geometry: the kagome lattice is a triangular Bravais lattice
A1 = (2, 0), A2 = (1, sqrt(3)) with a 3-site basis at (0,0), (1,0),
(1/2, sqrt(3)/2); every site has 4 NN at distance 1 (corner-sharing up/down
triangles); hopping -ts on every NN bond.

Physics anchors (tests): flat band at -2*ts (for hopping amplitude +ts the
kagome spectrum is {flat at -2t, dispersive}); Dirac bands; hermiticity.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..lattice import build_kgrid
from ..utils.reshape import nnn2lso

POSITIONS = np.array([[0.0, 0.0], [1.0, 0.0], [0.5, np.sqrt(3) / 2]])
SUPERCELL = np.array([[2.0, 0.0], [1.0, np.sqrt(3)]])


def _bonds(tol=1e-8):
    out = []
    for n1 in (-1, 0, 1):
        for n2 in (-1, 0, 1):
            shift = n1 * SUPERCELL[0] + n2 * SUPERCELL[1]
            for i in range(3):
                for j in range(3):
                    d = POSITIONS[j] + shift - POSITIONS[i]
                    if abs(np.hypot(*d) - 1.0) < tol:
                        out.append((i, j, (n1, n2)))
    return out


_BONDS = _bonds()


def kagome_hk_at(kpoint, ts: float, nspin: int = 1) -> np.ndarray:
    h = np.zeros((3, 3, nspin, nspin, 1, 1), np.complex128)
    for s in range(nspin):
        for (i, j, (n1, n2)) in _BONDS:
            rvec = n1 * SUPERCELL[0] + n2 * SUPERCELL[1]
            ph = np.exp(1j * (kpoint[0] * rvec[0] + kpoint[1] * rvec[1]))
            h[i, j, s, s, 0, 0] += -ts * ph
    return h


def kagome_cluster_hloc(ts: float, nspin: int = 1) -> np.ndarray:
    h = np.zeros((3, 3, nspin, nspin, 1, 1), np.complex128)
    for s in range(nspin):
        for (i, j, (n1, n2)) in _BONDS:
            if (n1, n2) == (0, 0):
                h[i, j, s, s, 0, 0] += -ts
    return h


def kagome_cluster_hk(nk: int, ts: float, nspin: int = 1
                      ) -> Tuple[np.ndarray, np.ndarray]:
    b = 2 * np.pi * np.linalg.inv(SUPERCELL).T
    frac = build_kgrid(nk, 2) / (2 * np.pi)
    hloc = kagome_cluster_hloc(ts, nspin)
    hks = [nnn2lso(kagome_hk_at(f[0] * b[0] + f[1] * b[1], ts, nspin),
                   3, nspin, 1) for f in frac]
    return np.stack(hks), hloc
