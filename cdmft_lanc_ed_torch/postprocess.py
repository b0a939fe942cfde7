"""Postprocessing: quasiparticle weights, band structures, topology.

Port of the JAX package's ``postprocess.py`` (the reference's
postprocessing drivers, drivers/cdn_bhz_postprocessing.f90:252-568, and
ED_GREENS_FUNCTIONS.f90:114-127):

* quasiparticle weight Z = [1 - Im Sigma(i w_0)/w_0]^{-1}, the scattering
  rate and the Z(k) matrices (host numpy on small matrices);
* topological Hamiltonian H_top(k) = H(k) + Re Sigma_per(k, w -> 0)
  (hk_topological, cdn_bhz_postprocessing.f90:307-327);
* band structures along a k path and the lattice Chern number by the
  Fukui-Hatsugai-Suzuki plaquette method, with the spin Chern / Z2 marker
  for spin-conserving models: H(k) is built on the host at every k, then
  one batched Hermitian eigensolve and the link products run on the
  device in complex128.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .config import EDConfig
from .device import resolve_device
from .utils.reshape import nnn2lso


def quasiparticle_weight(cfg: EDConfig, smats_nnn: np.ndarray) -> np.ndarray:
    """Z_a = [1 - Im Sigma_aa(i w_0)/w_0]^{-1} per diagonal lso component."""
    w0 = np.pi / cfg.beta
    s0 = nnn2lso(smats_nnn[..., 0], cfg.nlat, cfg.nspin, cfg.norb)
    return 1.0 / (1.0 - np.imag(np.diag(s0)) / w0)


def scattering_rate(cfg: EDConfig, smats_nnn: np.ndarray) -> np.ndarray:
    """Low-frequency extrapolation of -Im Sigma(i w -> 0) per component
    (from the first two Matsubara points, reference 'sig' files)."""
    w = np.pi / cfg.beta * np.array([1.0, 3.0])
    s = nnn2lso(smats_nnn[..., :2], cfg.nlat, cfg.nspin, cfg.norb)
    i1 = np.imag(np.diagonal(s[..., 0]))
    i2 = np.imag(np.diagonal(s[..., 1]))
    # linear extrapolation to w=0
    return -(i1 - (i2 - i1) / (w[1] - w[0]) * w[0])


# ---------------------------------------------------------------------------
# Z(k) matrices (zmats/zmats_component, cdn_bhz_postprocessing.f90:273-304)
# ---------------------------------------------------------------------------

def zmats_matrix(cfg: EDConfig, sigma_so_iw1: np.ndarray) -> np.ndarray:
    """Z(k) = [ |I - Im Sigma_per(k, iw_1) / (pi/beta)| ]^{-1} from the
    periodized self-energy at the first Matsubara frequency (zmats,
    cdn_bhz_postprocessing.f90:273-289)."""
    nso = sigma_so_iw1.shape[0]
    z = np.abs(np.eye(nso) - np.imag(np.asarray(sigma_so_iw1))
               / (np.pi / cfg.beta))
    return np.linalg.inv(z)


def zmats_component(cfg: EDConfig, sigma_so_iw1: np.ndarray) -> np.ndarray:
    """The reference's zmats_component (cdn_bhz_postprocessing.f90:
    291-304): the diagonal carries (Z_11, Z_12) of the full Z matrix, the
    orbital-mixing weight plotted along k paths."""
    zt = zmats_matrix(cfg, sigma_so_iw1)
    z = np.zeros_like(zt)
    z[0, 0] = zt[0, 0]
    z[1, 1] = zt[0, 1]
    return z


# ---------------------------------------------------------------------------
# topological Hamiltonian + band structure
# ---------------------------------------------------------------------------

def topological_hamiltonian(hk_per: Callable[[np.ndarray], np.ndarray],
                            sigma0_of_k: Callable[[np.ndarray], np.ndarray]
                            ) -> Callable[[np.ndarray], np.ndarray]:
    """H_top(k) = H_per(k) + Re Sigma_per(k, w->0)
    (hk_topological, cdn_bhz_postprocessing.f90:307-327)."""

    def h(k):
        return np.asarray(hk_per(k)) + np.real(np.asarray(sigma0_of_k(k)))

    return h


def unperiodized_topological_hamiltonian(
        hk_cluster: Callable[[np.ndarray], np.ndarray],
        sigma_cluster_0: np.ndarray) -> Callable[[np.ndarray], np.ndarray]:
    """Cluster-BZ (unperiodized) topological Hamiltonian
    H_top(k) = H_cluster(k) + Re Sigma_cluster(w->0) on the full
    [Nlso, Nlso] cluster Bloch matrix (hk_unperiodized_topological,
    cdn_bhz_postprocessing.f90:330-348; the Hermitian part of the complex
    Sigma the reference hands its band solver is Re Sigma)."""
    s0 = np.real(np.asarray(sigma_cluster_0))
    s0 = 0.5 * (s0 + s0.T)

    def h(k):
        return np.asarray(hk_cluster(k)) + s0

    return h


def _hk_stack(hk: Callable[[np.ndarray], np.ndarray], ks, device
              ) -> torch.Tensor:
    """H(k) at every k of ``ks``: [len(ks), n, n] complex128 on
    ``device``."""
    return torch.as_tensor(np.stack([np.asarray(hk(k), np.complex128)
                                     for k in ks])).to(device)


def band_structure(hk: Callable[[np.ndarray], np.ndarray],
                   kpath: Sequence[np.ndarray], npts: int = 40,
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(kdist, bands[nk, nbands]) along the polyline ``kpath``."""
    device = resolve_device(device)
    ks: List[np.ndarray] = []
    dist = [0.0]
    for a, b in zip(kpath[:-1], kpath[1:]):
        seg = np.linspace(0, 1, npts, endpoint=False)[:, None] \
            * (np.asarray(b) - np.asarray(a))[None, :] + np.asarray(a)
        ks.extend(seg)
    ks.append(np.asarray(kpath[-1]))
    for i in range(1, len(ks)):
        dist.append(dist[-1] + np.linalg.norm(ks[i] - ks[i - 1]))
    bands = torch.linalg.eigvalsh(_hk_stack(hk, ks, device))
    return np.asarray(dist), bands.cpu().numpy()


# ---------------------------------------------------------------------------
# Chern number (Fukui-Hatsugai-Suzuki) and spin Chern / Z2
# ---------------------------------------------------------------------------

def chern_number(hk: Callable[[np.ndarray], np.ndarray],
                 reciprocal: np.ndarray, nk: int,
                 bands: Sequence[int], device=None) -> float:
    """Lattice Chern number of the selected band subspace over the BZ
    spanned by the rows of ``reciprocal`` [2, 2]: the eigenvectors of the
    nk x nk grid in one batched eigensolve, the U(1) link of each grid
    bond a batched determinant."""
    device = resolve_device(device)
    ks = [(i / nk) * reciprocal[0] + (j / nk) * reciprocal[1]
          for i in range(nk) for j in range(nk)]
    _, v = torch.linalg.eigh(_hk_stack(hk, ks, device))
    sel = torch.as_tensor(list(bands), device=device)
    u = v[..., sel].reshape(nk, nk, v.shape[-2], len(sel))

    def link(a, b):
        """d/|d| of d = det(a^+ b); 1 where |d| <= 1e-14."""
        d = torch.linalg.det(a.conj().transpose(-2, -1) @ b)
        ok = d.abs() > 1e-14
        return torch.where(ok, d / torch.where(ok, d.abs(), 1.0),
                           torch.ones_like(d))

    u10 = torch.roll(u, -1, dims=0)
    u01 = torch.roll(u, -1, dims=1)
    u11 = torch.roll(u10, -1, dims=1)
    f = torch.angle(link(u, u10) * link(u10, u11) * link(u11, u01)
                    * link(u01, u))
    return float(f.sum()) / (2 * np.pi)


def spin_chern_z2(hk: Callable[[np.ndarray], np.ndarray],
                  reciprocal: np.ndarray, nk: int, nso: int,
                  filled_per_spin: int, device=None
                  ) -> Tuple[float, float, int]:
    """For spin-block-diagonal H (lso order: spin outer block):
    (C_up, C_dw, Z2) with Z2 = (C_up - C_dw)/2 mod 2."""
    n = nso // 2

    def block(s):
        def h(k):
            full = np.asarray(hk(k))
            return full[s * n:(s + 1) * n, s * n:(s + 1) * n]
        return h

    c_up = chern_number(block(0), reciprocal, nk, range(filled_per_spin),
                        device=device)
    c_dw = chern_number(block(1), reciprocal, nk, range(filled_per_spin),
                        device=device)
    z2 = int(round((c_up - c_dw) / 2)) % 2
    return c_up, c_dw, z2
