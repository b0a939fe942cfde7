"""Lattice layer: k-grids, local Green's function, DMFT self-consistency.

Port of the JAX package's ``lattice.py`` (replacing the DMFTtools routines
the reference drivers call: ``dmft_gloc_matsubara``,
``dmft_self_consistency``, ``check_convergence``, ``TB_build_kgrid``).
The (k, omega) linear algebra is batched complex128 inversion on the
device.  Cluster functions are in 'nnn' shape
[Nlat,Nlat,Nspin,Nspin,Norb,Norb,L]; H(k) in lso shape [Nk, Nlso, Nlso].
The chemical-potential search (``MuSearch``) is a later slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import EDConfig
from .device import resolve_device
from .utils.reshape import lso2nnn, nnn2lso


def build_kgrid(nk: int, ndim: int) -> np.ndarray:
    """Uniform Monkhorst-Pack-style grid in [0, 2pi)^ndim: [Nk^ndim, ndim]."""
    pts = 2.0 * np.pi * np.arange(nk) / nk
    grids = np.meshgrid(*([pts] * ndim), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def _freq_lso(cfg: EDConfig, f_nnn: np.ndarray, device) -> torch.Tensor:
    """nnn [..., L] host array -> [L, Nlso, Nlso] complex128 on device."""
    a = np.moveaxis(nnn2lso(np.asarray(f_nnn, np.complex128), cfg.nlat,
                            cfg.nspin, cfg.norb), -1, 0)
    return torch.as_tensor(np.ascontiguousarray(a)).to(device)


def _nnn(cfg: EDConfig, f_lso: torch.Tensor) -> np.ndarray:
    return lso2nnn(np.moveaxis(f_lso.cpu().numpy(), 0, -1), cfg.nlat,
                   cfg.nspin, cfg.norb)


def gloc_lattice(z: torch.Tensor, hk: torch.Tensor, sigma_lso: torch.Tensor,
                 xmu: float, chunk: int = 256) -> torch.Tensor:
    """G_loc(z) = 1/Nk sum_k [(z+mu)I - H(k) - Sigma(z)]^{-1}; chunked over
    frequencies to bound the [L, Nk, n, n] intermediate."""
    n = hk.shape[-1]
    eye = torch.eye(n, dtype=torch.complex128, device=hk.device)
    out = torch.empty_like(sigma_lso)
    for i in range(0, len(z), chunk):
        zc, sc = z[i:i + chunk], sigma_lso[i:i + chunk]
        a = ((zc[:, None, None] + xmu) * eye - sc)[:, None] - hk[None]
        out[i:i + chunk] = torch.linalg.inv(a).mean(dim=1)
    return out


def dmft_gloc_matsubara(cfg: EDConfig, hk: np.ndarray, smats_nnn: np.ndarray,
                        device=None) -> np.ndarray:
    """Matsubara local GF in nnn shape (dmft_gloc_matsubara equivalent)."""
    device = resolve_device(device)
    wm = np.pi / cfg.beta * (2 * np.arange(smats_nnn.shape[-1]) + 1)
    g = gloc_lattice(torch.as_tensor(1j * wm).to(device),
                     torch.as_tensor(np.asarray(hk, np.complex128))
                     .to(device),
                     _freq_lso(cfg, smats_nnn, device), cfg.xmu)
    return _nnn(cfg, g)


def dmft_self_consistency(cfg: EDConfig, gloc_nnn: np.ndarray,
                          smats_nnn: np.ndarray,
                          hloc_nnn: Optional[np.ndarray] = None,
                          scheme: Optional[str] = None,
                          device=None) -> np.ndarray:
    """Weiss field update.

    scheme "weiss":  G0^{-1} = G_loc^{-1} + Sigma  ->  returns G0
    scheme "delta":  Delta = (z+mu)I - Hloc - [G_loc^{-1} + Sigma]
    (DMFTtools usage in drivers/cdn_hm_2dsquare.f90:159).
    """
    device = resolve_device(device)
    scheme = scheme or cfg.cg_scheme
    l = gloc_nnn.shape[-1]
    g = _freq_lso(cfg, gloc_nnn, device)
    s = _freq_lso(cfg, smats_nnn, device)
    g0inv = torch.linalg.inv(g) + s
    if scheme == "weiss":
        out = torch.linalg.inv(g0inv)
    else:
        if hloc_nnn is None:
            raise ValueError("delta scheme requires hloc")
        wm = np.pi / cfg.beta * (2 * np.arange(l) + 1)
        hloc = torch.as_tensor(np.ascontiguousarray(nnn2lso(
            np.asarray(hloc_nnn, np.complex128), cfg.nlat, cfg.nspin,
            cfg.norb))).to(device)
        eye = torch.eye(cfg.nlso, dtype=torch.complex128, device=device)
        z = torch.as_tensor(1j * wm).to(device)
        out = (z[:, None, None] + cfg.xmu) * eye - hloc[None] - g0inv
    return _nnn(cfg, out)


class ConvergenceCheck:
    """Relative-change convergence test with success-count semantics
    (DMFTtools check_convergence: err = sum|f - f_prev| / sum|f|)."""

    def __init__(self, threshold: float, nsuccess: int = 1):
        self.threshold = threshold
        self.nsuccess = nsuccess
        self.prev: Optional[np.ndarray] = None
        self.count = 0
        self.error = np.inf

    def __call__(self, f: np.ndarray) -> bool:
        f = np.asarray(f)
        if self.prev is None:
            self.error = np.inf
        else:
            num = np.abs(f - self.prev).sum()
            den = max(np.abs(f).sum(), 1e-300)
            self.error = num / den
        self.prev = f.copy()
        if self.error < self.threshold:
            self.count += 1
        else:
            self.count = 0
        return self.count >= self.nsuccess
