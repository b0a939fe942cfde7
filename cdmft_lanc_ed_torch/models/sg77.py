"""Space-group-77 tetragonal two-orbital model, Nx-site cluster along x.

Copy of the JAX package's ``models/sg77.py``; counterpart of the
reference's drivers/cdn_sg77.f90 (hloc_model
:131-162, hk_model :164-225, generate_hk_hloc :231-266): a 3d lattice
with two orbitals per site and nine symmetry-allowed hopping families
(spin-diagonal, sigma_z-signed intra-orbital terms 1-4 plus
orbital-off-diagonal terms 5-9).  Only the first and last cluster sites
carry inter-cell terms (the reference driver is written for Nx=2).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..utils.reshape import nnn2lso


def _hop(hm, i, j, s, o1, o2, amp):
    hm[i, j, s, s, o1, o2] += amp


def sg77_cluster_hloc(nx: int, ts: float, nspin: int = 2) -> np.ndarray:
    """Local (intra-cluster) part (cdn_sg77.f90:131-162)."""
    hm = np.zeros((nx, nx, nspin, nspin, 2, 2), np.complex128)
    lst = nx - 1
    for s in range(nspin):
        if nx > 1:
            # Hop 1 local half (intra-orbital, sigma_z sign)
            for (o, sg) in ((0, 1.0), (1, -1.0)):
                _hop(hm, lst, 0, s, o, o, sg * ts / 2)
                _hop(hm, 0, lst, s, o, o, sg * ts / 2)
            # Hop 5 local half (orbital off-diagonal)
            for (o1, o2) in ((0, 1), (1, 0)):
                _hop(hm, lst, 0, s, o1, o2, ts / 4)
                _hop(hm, 0, lst, s, o1, o2, ts / 4)
        # Hop 8: on-site orbital mixing
        for (o1, o2) in ((0, 1), (1, 0)):
            _hop(hm, 0, 0, s, o1, o2, ts)
            _hop(hm, lst, lst, s, o1, o2, ts)
    return hm


def sg77_hk_at(kpoint: np.ndarray, nx: int, ts: float,
               nspin: int = 2) -> np.ndarray:
    """Bloch Hamiltonian [Nlso, Nlso] at a 3d k-point
    (cdn_sg77.f90:164-225); includes the local part."""
    kx, ky, kz = (float(kpoint[0]), float(kpoint[1]), float(kpoint[2]))
    hm = np.zeros((nx, nx, nspin, nspin, 2, 2), np.complex128)
    lst = nx - 1

    def ph(r):  # e^{-i k.r}
        return np.exp(-1j * (kx * r[0] + ky * r[1] + kz * r[2]))

    for s in range(nspin):
        for (o, sg) in ((0, 1.0), (1, -1.0)):
            # Hop 1 (k-dependent half): +-(ts/2) e^{+-i kx Nx}
            _hop(hm, lst, 0, s, o, o, sg * (ts / 2) * np.exp(1j * kx * nx))
            _hop(hm, 0, lst, s, o, o, sg * (ts / 2) * np.exp(-1j * kx * nx))
            # Hop 2: on-site -+(ts) cos(ky)
            for i in (0, lst):
                _hop(hm, i, i, s, o, o, -sg * ts * np.cos(ky))
            # Hop 3
            _hop(hm, lst, 0, s, o, o,
                 -sg * (ts / 4) * (ph([0, 1, 0]) + ph([-nx, -1, 0])))
            _hop(hm, 0, lst, s, o, o,
                 -sg * (ts / 4) * (ph([nx, 1, 0]) + ph([0, -1, 0])))
            # Hop 4
            _hop(hm, lst, 0, s, o, o,
                 sg * (ts / 4) * (ph([-nx, 1, 0]) + ph([0, -1, 0])))
            _hop(hm, 0, lst, s, o, o,
                 sg * (ts / 4) * (ph([nx, -1, 0]) + ph([0, 1, 0])))
        # Hop 5 (k-dependent half), both orbital off-diagonals
        for (o1, o2) in ((0, 1), (1, 0)):
            _hop(hm, lst, 0, s, o1, o2, (ts / 4) * np.exp(1j * kx * nx))
            _hop(hm, 0, lst, s, o1, o2, (ts / 4) * np.exp(-1j * kx * nx))
        # Hops 6, 7 (on-site, +-(y+-z) neighbours) and 9 (z-axis)
        for i in (0, lst):
            _hop(hm, i, i, s, 0, 1, (ts / 4) * ph([0, -1, -1]))
            _hop(hm, i, i, s, 1, 0, (ts / 4) * ph([0, 1, 1]))
            _hop(hm, i, i, s, 0, 1, (ts / 4) * ph([0, 1, -1]))
            _hop(hm, i, i, s, 1, 0, (ts / 4) * ph([0, -1, 1]))
            _hop(hm, i, i, s, 0, 1, ts * np.exp(1j * kz))
            _hop(hm, i, i, s, 1, 0, ts * np.exp(-1j * kz))
    hm += sg77_cluster_hloc(nx, ts, nspin)
    return nnn2lso(hm, nx, nspin, 2)


def sg77_cluster_hk(nx: int, nk: int, ts: float, nspin: int = 2
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(Hk [nk^3, Nlso, Nlso], Hloc nnn) on the reference's 3d BZ grid:
    kx in [0, 2pi/Nx), ky, kz in [0, 2pi) (TB_set_bk, cdn_sg77.f90:239-244).
    """
    kxs = 2.0 * np.pi / nx * np.arange(nk) / nk
    kys = 2.0 * np.pi * np.arange(nk) / nk
    kzs = 2.0 * np.pi * np.arange(nk) / nk
    hks = []
    for kx in kxs:
        for ky in kys:
            for kz in kzs:
                hks.append(sg77_hk_at(np.array([kx, ky, kz]), nx, ts,
                                      nspin))
    return np.stack(hks), sg77_cluster_hloc(nx, ts, nspin)
