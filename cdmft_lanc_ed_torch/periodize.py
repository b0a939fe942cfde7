"""Periodization of cluster quantities to lattice quantities.

Port of the JAX package's ``periodize.py`` (the reference's driver
postprocessing, drivers/auxiliary_routines.f90:8-188): a cluster-matrix
Green's function or self-energy becomes a periodized (Nspin*Norb) lattice
function by the Fourier phase sum over cluster sites,

    X_per(k, z) = 1/Nlat sum_{IJ} e^{-i k (R_I - R_J)} X_IJ(k, z)

Every function works on the device in complex128: the per-frequency
inversions are one batched ``torch.linalg.inv`` and the phase sum one
einsum over the lso layout (index ``iorb + ilat*Norb + ispin*Norb*Nlat``).
Inputs and outputs are host numpy arrays in the JAX package's shapes.

Schemes (cdn_bhz_postprocessing.f90:354-568;
cdn_ssh_postprocessing.f90:210-306):
  * G-scheme     : periodize G, then Sigma_per = G0_per^{-1} - G_per^{-1}
  * Sigma-scheme : periodize Sigma directly, then G from it
  * M-scheme     : periodize the cumulant M = [(z+mu)I - Sigma]^{-1},
                   then Sigma_per = (z+mu)I - M_per^{-1} (also onto an
                   nsub-site unit cell)
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .config import EDConfig
from .device import resolve_device
from .utils.reshape import nnn2lso, so2nn


def cluster_coords(nlat: int, nx: int, ny: int) -> np.ndarray:
    """[Nlat, ndim] integer coordinates of cluster sites (site = ix+iy*Nx,
    the drivers' indices2N convention)."""
    assert nx * ny == nlat
    if ny == 1:
        return np.arange(nx).reshape(-1, 1).astype(float)
    coords = [(ix, iy) for iy in range(ny) for ix in range(nx)]
    return np.array(coords, dtype=float)


def _phases(kpoint: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """[Nlat, Nlat]: e^{-i k (R_I - R_J)} / Nlat."""
    kr = coords @ np.asarray(kpoint)[: coords.shape[1]]
    return np.exp(-1j * (kr[:, None] - kr[None, :])) / len(coords)


def _dev(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(
        np.asarray(a, np.complex128))).to(device)


def _lso_freq(f_nnn: np.ndarray, nlat: int, nspin: int, norb: int,
              device) -> torch.Tensor:
    """nnn [..., L] host array -> [L, Nlso, Nlso] on ``device``."""
    return _dev(np.moveaxis(nnn2lso(np.asarray(f_nnn), nlat, nspin, norb),
                            -1, 0), device)


def _zmu(z: np.ndarray, xmu: float, n: int, device) -> torch.Tensor:
    """(z + mu) I as [L, n, n]."""
    eye = torch.eye(n, dtype=torch.complex128, device=device)
    return (_dev(z, device)[:, None, None] + xmu) * eye


def _phase_sum(ph: np.ndarray, x: torch.Tensor, nlat: int, nspin: int,
               norb: int) -> torch.Tensor:
    """sum_IJ ph[I, J] X_IJ of x [L, Nlso, Nlso]: [L, Nso, Nso]."""
    l = x.shape[0]
    x7 = x.reshape(l, nspin, nlat, norb, nspin, nlat, norb)
    out = torch.einsum("ij,lsiatjb->lsatb", _dev(ph, x.device), x7)
    return out.reshape(l, nspin * norb, nspin * norb)


def _nn(x: torch.Tensor, nspin: int, norb: int) -> np.ndarray:
    """[L, Nso, Nso] device tensor -> host [Nspin, Nspin, Norb, Norb, L]."""
    return so2nn(np.moveaxis(x.cpu().numpy(), 0, -1), nspin, norb)


def _g_per_so(cfg: EDConfig, kpoint, coords, hk_unper, smats_nnn, z,
              device) -> torch.Tensor:
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    s_lso = _lso_freq(smats_nnn, nlat, nspin, norb, device)
    g = torch.linalg.inv(_zmu(z, cfg.xmu, cfg.nlso, device)
                         - _dev(hk_unper, device)[None] - s_lso)
    return _phase_sum(_phases(kpoint, coords), g, nlat, nspin, norb)


def periodize_g_scheme(cfg: EDConfig, kpoint, coords: np.ndarray,
                       hk_unper: np.ndarray, smats_nnn: np.ndarray,
                       z: np.ndarray, device=None) -> np.ndarray:
    """G-scheme periodized GF at one k over frequencies ``z``:
    returns [Nspin, Nspin, Norb, Norb, L]
    (periodize_g_scheme, auxiliary_routines.f90:8-70)."""
    device = resolve_device(device)
    return _nn(_g_per_so(cfg, kpoint, coords, hk_unper, smats_nnn, z,
                         device), cfg.nspin, cfg.norb)


def build_sigma_g_scheme(cfg: EDConfig, kpoint, coords: np.ndarray,
                         hk_unper: np.ndarray, hk_per: np.ndarray,
                         smats_nnn: np.ndarray, z: np.ndarray, device=None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(G_per, Sigma_per) at one k: Sigma_per = G0_per^{-1} - G_per^{-1}
    (build_sigma_g_scheme, auxiliary_routines.f90:74-131)."""
    device = resolve_device(device)
    nso = cfg.nspin * cfg.norb
    g_so = _g_per_so(cfg, kpoint, coords, hk_unper, smats_nnn, z, device)
    invg0 = _zmu(z, cfg.xmu, nso, device) - _dev(hk_per, device)[None]
    s_so = invg0 - torch.linalg.inv(g_so)
    return _nn(g_so, cfg.nspin, cfg.norb), _nn(s_so, cfg.nspin, cfg.norb)


def periodize_sigma_scheme(cfg: EDConfig, kpoint, coords: np.ndarray,
                           hk_per: np.ndarray, smats_nnn: np.ndarray,
                           z: np.ndarray, device=None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Sigma-scheme: periodize Sigma directly, then
    G_per = [(z+mu) - Hk_per - Sigma_per]^{-1}
    (periodize_sigma_scheme, auxiliary_routines.f90:135-188)."""
    device = resolve_device(device)
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    s_so = _phase_sum(_phases(kpoint, coords),
                      _lso_freq(smats_nnn, nlat, nspin, norb, device),
                      nlat, nspin, norb)
    g_so = torch.linalg.inv(_zmu(z, cfg.xmu, nspin * norb, device)
                            - _dev(hk_per, device)[None] - s_so)
    return _nn(g_so, nspin, norb), _nn(s_so, nspin, norb)


def build_g_sigma_scheme(cfg: EDConfig, kpoint, coords: np.ndarray,
                         hk_per: np.ndarray, smats_nnn: np.ndarray,
                         z: np.ndarray, device=None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(G_per, Sigma_per) with Sigma periodized first and G rebuilt from
    it, the reference's fourth scheme (build_g_sigma_scheme,
    auxiliary_routines.f90:164-193): the math of
    :func:`periodize_sigma_scheme`, in the (G, Sigma) order the reference
    returns."""
    return periodize_sigma_scheme(cfg, kpoint, coords, hk_per, smats_nnn,
                                  z, device=device)


def periodize_m_scheme_local(cfg: EDConfig, kpoint, coords: np.ndarray,
                             h_local_cluster: np.ndarray,
                             hk_per_hop: np.ndarray,
                             hk_per_full: np.ndarray,
                             s_nnn: np.ndarray, z: np.ndarray, device=None
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """BHZ-style cumulant (M-scheme) periodization
    (periodize_sigma_Mscheme_mats/real, cdn_bhz_postprocessing.f90:
    580-712):

        M(z)        = [(z+mu)I - H_local - Sigma(z)]^{-1}   (cluster)
        M_per(k,z)  = 1/Nlat sum_IJ e^{-ik(R_I-R_J)} M_IJ(z)
        G_per^{-1}  = M_per^{-1} - Hk_hop(k)
        Sigma_per   = (z+mu)I - Hk_full(k) - G_per^{-1}

    ``h_local_cluster`` is the k-independent local cluster Hamiltonian
    ([Nlso, Nlso]); ``hk_per_hop`` the periodized Bloch Hamiltonian with
    its local part zeroed and ``hk_per_full`` the full one ([Nso, Nso]).
    Returns (G_per, Sigma_per) as [Nspin, Nspin, Norb, Norb, L] arrays."""
    device = resolve_device(device)
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    nso = nspin * norb
    s_lso = _lso_freq(s_nnn, nlat, nspin, norb, device)
    m = torch.linalg.inv(_zmu(z, cfg.xmu, cfg.nlso, device)
                         - _dev(h_local_cluster, device)[None] - s_lso)
    m_so = _phase_sum(_phases(kpoint, coords), m, nlat, nspin, norb)
    ginv = torch.linalg.inv(m_so) - _dev(hk_per_hop, device)[None]
    s_so = _zmu(z, cfg.xmu, nso, device) - _dev(hk_per_full, device)[None] \
        - ginv
    return (_nn(torch.linalg.inv(ginv), nspin, norb),
            _nn(s_so, nspin, norb))


def periodize_m_scheme(cfg: EDConfig, kpoint, cell_pos: np.ndarray,
                       site_sub: np.ndarray, nsub: int,
                       s_nnn: np.ndarray, z: np.ndarray, device=None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Cumulant (M-scheme) periodization onto an ``nsub``-site unit cell.

    The cluster cumulant M(z) = [(z+mu)I - Sigma(z)]^{-1} is Fourier-summed
    over unit-cell positions, keeping the within-cell (sublattice)
    structure:

        M_per[s1,s2](k,z) = 1/Ncell sum_{ij} e^{-i k.(R_i-R_j)} M_ij(z)

    with R_i the CELL position of cluster site i (``cell_pos[i]``) and
    s_i = ``site_sub[i]`` its sublattice.  Returns (M_per, Sigma_per) as
    [nsub*Nspin*Norb, nsub*Nspin*Norb, L] lso arrays with
    Sigma_per = (z+mu)I - M_per^{-1}
    (periodize_sigma_Mscheme_real, cdn_ssh_postprocessing.f90:210-259).
    """
    device = resolve_device(device)
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    s_lso = _lso_freq(s_nnn, nlat, nspin, norb, device)
    m = torch.linalg.inv(_zmu(z, cfg.xmu, cfg.nlso, device) - s_lso)
    cell_pos = np.asarray(cell_pos, float).reshape(nlat, -1)
    kr = cell_pos @ np.asarray(kpoint, float)[: cell_pos.shape[1]]
    ph = np.exp(-1j * (kr[:, None] - kr[None, :])) / (nlat / nsub)
    u = np.zeros((nlat, nsub))
    u[np.arange(nlat), np.asarray(site_sub, int)] = 1.0
    l = m.shape[0]
    m7 = m.reshape(l, nspin, nlat, norb, nspin, nlat, norb)
    niso = nsub * nspin * norb
    m_per = torch.einsum("ij,ip,jq,lsiatjb->lspatqb", _dev(ph, device),
                         _dev(u, device), _dev(u, device), m7
                         ).reshape(l, niso, niso)
    s_per = _zmu(z, cfg.xmu, niso, device) - torch.linalg.inv(m_per)
    return (np.moveaxis(m_per.cpu().numpy(), 0, -1),
            np.moveaxis(s_per.cpu().numpy(), 0, -1))
