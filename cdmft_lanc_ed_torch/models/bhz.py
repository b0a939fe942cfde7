"""BHZ (Bernevig-Hughes-Zhang) model on a cluster-tiled 2d square lattice.

Counterpart of the reference driver model (drivers/
cdn_bhz_2d.f90:213-310): Norb=2, Nspin=2, spin-diagonal but complex
orbital structure:

    t_m        = Mh * sigma_z                      (on-site)
    t_x(spin)  = -ts*sigma_z + (+/-) i lambda/2 sigma_x   (x bonds, spin +/-)
    t_y        = -ts*sigma_z - lambda/2 (i sigma_y)       (y bonds)

Site convention: cluster site index = ix + iy*Nx (0-based).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..lattice import build_kgrid
from ..utils.reshape import nnn2lso

SX = np.array([[0, 1], [1, 0]], dtype=np.complex128)
SY = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
SZ = np.array([[1, 0], [0, -1]], dtype=np.complex128)


def t_m(mh: float) -> np.ndarray:
    return mh * SZ


def t_x(ts: float, lam: float, ispin: int) -> np.ndarray:
    sz = 1.0 if ispin == 0 else -1.0
    return -ts * SZ + 0.5 * sz * 1j * lam * SX


def t_y(ts: float, lam: float) -> np.ndarray:
    m = -ts * SZ.copy()
    m[0, 1] += -0.5 * lam
    m[1, 0] += 0.5 * lam
    return m


def bhz_cluster_hloc(nx: int, ny: int, mh: float, ts: float,
                     lam: float) -> np.ndarray:
    """Intra-cluster BHZ Hamiltonian [Nlat,Nlat,2,2,2,2]
    (hloc_model, cdn_bhz_2d.f90:213-249)."""
    nlat = nx * ny
    h = np.zeros((nlat, nlat, 2, 2, 2, 2), np.complex128)

    def idx(ix, iy):
        return ix + iy * nx

    for s in range(2):
        for ix in range(nx):
            for iy in range(ny):
                i = idx(ix, iy)
                h[i, i, s, s] += t_m(mh)
                if ix + 1 < nx:
                    j = idx(ix + 1, iy)
                    h[j, i, s, s] += t_x(ts, lam, s)
                    h[i, j, s, s] += t_x(ts, lam, s).conj().T
                if iy + 1 < ny:
                    j = idx(ix, iy + 1)
                    h[j, i, s, s] += t_y(ts, lam)
                    h[i, j, s, s] += t_y(ts, lam).T
    return h


def bhz_cluster_hk(nx: int, ny: int, nk: int, mh: float, ts: float,
                   lam: float) -> Tuple[np.ndarray, np.ndarray]:
    """(Hk [Nk^2, Nlso, Nlso], Hloc nnn) for the cluster-tiled BHZ model
    (hk_model, cdn_bhz_2d.f90:251-276)."""
    nlat = nx * ny
    hloc = bhz_cluster_hloc(nx, ny, mh, ts, lam)
    kgrid = build_kgrid(nk, 2)

    def idx(ix, iy):
        return ix + iy * nx

    hks = []
    for kx, ky in kgrid:
        h = np.array(hloc)
        for s in range(2):
            for iy in range(ny):
                a, b = idx(0, iy), idx(nx - 1, iy)
                h[b, a, s, s] += t_x(ts, lam, s).conj().T \
                    * np.exp(1j * kx * nx)
                h[a, b, s, s] += t_x(ts, lam, s) * np.exp(-1j * kx * nx)
            for ix in range(nx):
                a, b = idx(ix, 0), idx(ix, ny - 1)
                h[b, a, s, s] += t_y(ts, lam).T * np.exp(1j * ky * ny)
                h[a, b, s, s] += t_y(ts, lam) * np.exp(-1j * ky * ny)
        hks.append(nnn2lso(h, nlat, 2, 2))
    return np.stack(hks), hloc


def bhz_chain_hk(nx: int, ny: int, nk: int, mh: float, ts: float,
                 lam: float) -> Tuple[np.ndarray, np.ndarray]:
    """x-periodic, y-open BHZ: the 1d-chain driver (ny=1,
    cdn_bhz_1d.f90:64) and the edge/ribbon geometry (ny = strip width,
    cdn_bhz_2d_edge) share this builder: Bloch phases only along x."""
    nlat = nx * ny
    hloc = bhz_cluster_hloc(nx, ny, mh, ts, lam)

    def idx(ix, iy):
        return ix + iy * nx

    hks = []
    for k in 2.0 * np.pi * np.arange(nk) / nk:
        h = np.array(hloc)
        for s in range(2):
            for iy in range(ny):
                a, b = idx(0, iy), idx(nx - 1, iy)
                h[b, a, s, s] += t_x(ts, lam, s).conj().T \
                    * np.exp(1j * k * nx)
                h[a, b, s, s] += t_x(ts, lam, s) * np.exp(-1j * k * nx)
        hks.append(nnn2lso(h, nlat, 2, 2))
    return np.stack(hks), hloc


def bhz_alternated_hk(nk: int, mh: float, ts: float, lam: float
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Alternated (checkerboard) tiling of the 2-site BHZ cluster
    (cdn_bhz_2d_alternated.f90:210-230): the (Nx=2, Ny=1) cluster tiles
    the square lattice on the 45-degree-rotated superlattice with period
    sqrt(2), so BOTH inter-cluster x and y bonds connect site 0 <-> 1 with
    Bloch phases e^{i k.(s2,s2)}, e^{i kx s2}, e^{i ky s2} (s2=sqrt 2)."""
    hloc = bhz_cluster_hloc(2, 1, mh, ts, lam)
    s2 = np.sqrt(2.0)
    kgrid = build_kgrid(nk, 2) / s2    # BZ of the sqrt(2)-period lattice
    hks = []
    for kx, ky in kgrid:
        h = np.array(hloc)
        for s in range(2):
            fwd = (t_x(ts, lam, s) * np.exp(-1j * (kx + ky) * s2)
                   + t_y(ts, lam).T * np.exp(-1j * kx * s2)
                   + t_y(ts, lam) * np.exp(-1j * ky * s2))
            h[1, 0, s, s] += fwd
            h[0, 1, s, s] += fwd.conj().T
        hks.append(nnn2lso(h, 2, 2, 2))
    return np.stack(hks), hloc


def bhz_bath_basis(nx: int, ny: int, mh: float, ts: float, lam: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(basis [3, ...nnn...], lambda0 [3]) — the reference's symmetry basis
    from unit-amplitude Hloc decompositions (cdn_bhz_2d.f90:106-117)."""
    b1 = bhz_cluster_hloc(nx, ny, 1.0, 0.0, 0.0)
    b2 = bhz_cluster_hloc(nx, ny, 0.0, 1.0, 0.0)
    b3 = bhz_cluster_hloc(nx, ny, 0.0, 0.0, 1.0)
    return np.stack([b1, b2, b3]), np.array([mh, ts, lam])
