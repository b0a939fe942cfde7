"""Cluster tight-binding models for the Hubbard drivers (host numpy; copy
of the JAX package's ``models/hubbard.py``).

Replaces the Hk/Hloc builder functions embedded in the reference drivers
(the reference's drivers/cdn_hm_2dsquare.f90:221-295,
 drivers/cdn_hm_1dchain.f90): the lattice is tiled by an (Nx x Ny) cluster
supercell; Hloc is the intra-cluster hopping, Hk adds the inter-cluster
terms with Bloch phases e^{i k . R} over the superlattice Brillouin zone.

Site convention: cluster site index = ix + iy*Nx (0-based, x fastest).
All matrices are in 'nnn' [Nlat,Nlat,Nspin,Nspin,Norb,Norb] or lso form.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..utils.reshape import nnn2lso
from ..lattice import build_kgrid


def square_cluster_hloc(nx: int, ny: int, ts: float = 1.0,
                        nspin: int = 1, norb: int = 1) -> np.ndarray:
    """Intra-cluster hopping of the 2d square lattice (open cluster),
    reference hloc_model (cdn_hm_2dsquare.f90:221-258)."""
    nlat = nx * ny
    h = np.zeros((nlat, nlat, nspin, nspin, norb, norb), np.complex128)

    def idx(ix, iy):
        return ix + iy * nx

    for s in range(nspin):
        for o in range(norb):
            for ix in range(nx):
                for iy in range(ny):
                    i = idx(ix, iy)
                    if ix + 1 < nx:
                        h[i, idx(ix + 1, iy), s, s, o, o] = -ts
                        h[idx(ix + 1, iy), i, s, s, o, o] = -ts
                    if iy + 1 < ny:
                        h[i, idx(ix, iy + 1), s, s, o, o] = -ts
                        h[idx(ix, iy + 1), i, s, s, o, o] = -ts
    return h


def square_cluster_hk(nx: int, ny: int, nk: int, ts: float = 1.0,
                      nspin: int = 1, norb: int = 1
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(Hk [Nk^2, Nlso, Nlso], Hloc nnn) for the cluster-tiled square
    lattice, reference hk_model (cdn_hm_2dsquare.f90:262-295).

    1d chains are the ny == 1 case with a 1d k-grid (cdn_hm_1dchain)."""
    nlat = nx * ny
    hloc = square_cluster_hloc(nx, ny, ts, nspin, norb)
    ndim = 2 if ny > 1 else 1
    kgrid = build_kgrid(nk, ndim)

    def idx(ix, iy):
        return ix + iy * nx

    hks = []
    for kpt in kgrid:
        kx = kpt[0]
        ky = kpt[1] if ndim == 2 else 0.0
        h = np.array(hloc)
        for s in range(nspin):
            for o in range(norb):
                # supercell neighbour along x: site (0,iy) <- (nx-1,iy)
                for iy in range(ny):
                    a, b = idx(0, iy), idx(nx - 1, iy)
                    ph = np.exp(1j * kx * nx)
                    h[a, b, s, s, o, o] += -ts * ph
                    h[b, a, s, s, o, o] += -ts * np.conj(ph)
                # supercell neighbour along y
                if ny > 1:
                    for ix in range(nx):
                        a, b = idx(ix, 0), idx(ix, ny - 1)
                        ph = np.exp(1j * ky * ny)
                        h[a, b, s, s, o, o] += -ts * ph
                        h[b, a, s, s, o, o] += -ts * np.conj(ph)
        hks.append(nnn2lso(h, nlat, nspin, norb))
    return np.stack(hks), hloc
