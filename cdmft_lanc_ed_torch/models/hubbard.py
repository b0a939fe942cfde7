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


def bethe_hk(nk: int, d: float = 1.0, nspin: int = 1) -> Tuple[np.ndarray,
                                                               np.ndarray]:
    """Single-site semicircular-DOS stand-in via a dense energy grid
    (useful for single-site DMFT cross-checks): returns (Hk-like array of
    energies weighted uniformly, Hloc=0)."""
    # sample the semicircle by inverse-CDF so a flat k-average reproduces it
    u = (np.arange(nk) + 0.5) / nk
    # invert CDF of rho(e)=2/(pi D^2) sqrt(D^2-e^2) numerically
    es = np.linspace(-d, d, 4001)
    rho = 2.0 / (np.pi * d ** 2) * np.sqrt(np.maximum(d ** 2 - es ** 2, 0))
    cdf = np.cumsum(rho)
    cdf /= cdf[-1]
    ek = np.interp(u, cdf, es)
    hk = ek.reshape(nk, 1, 1).astype(np.complex128)
    hloc = np.zeros((1, 1, nspin, nspin, 1, 1), np.complex128)
    return hk, hloc


def plaquette_replica_bath(nbath: int = 3, v: float = 0.5):
    """The Ns = 4 + 4·nbath plaquette of the JAX package's large-sector
    benchmark (its ``__graft_entry__._plaquette_bath_op``; at nbath=3 the
    Ns=16 flagship of the reference's ED_SETUP.f90:139-154) as a replica
    bath: hopping -1 on the four bonds of the 2x2 plaquette, bath levels
    lambda_b = -1 + 2b/(nbath-1) times delta_ij, and V = ``v`` on every
    site and bath.  Returns (hloc nnn, basis [1, 4,4,1,1,1,1],
    lambdas [nbath, 1], V [nbath, 4]) for ``EDSolver.set_hbath`` and
    ``bath.DmftBath``."""
    hloc = square_cluster_hloc(2, 2)
    basis = np.zeros((1, 4, 4, 1, 1, 1, 1), np.complex128)
    for i in range(4):
        basis[0, i, i, 0, 0, 0, 0] = 1.0
    lam = np.array([[-1.0 + 2.0 * b / max(nbath - 1, 1)]
                    for b in range(nbath)])
    return hloc, basis, lam, np.full((nbath, 4), v)
