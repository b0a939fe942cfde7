"""Custom observables: thermal averages of one-body lattice operators.

Port of the JAX package's ``custom_obs.py`` (the reference's
custom-observable registry, ED_OBSERVABLES.f90:696-960): observables

    <O> = sum_k Tr[ S(k) G(k, z) ]     (density-matrix contraction)

with G(k,z) = [(z+mu)I - H(k) - Sigma(z)]^{-1} and Sigma(z) rebuilt at
arbitrary z from the solver's stored GF poles and its bath.

* T=0: a real integral over the imaginary axis, <O> = s_mult/pi *
  Int_0^inf dw sum_k Re Tr[S_k G_k(iw) - S_k/(iw - 1.1)] (the subtracted
  tail is the reference's convergence device, ED_OBSERVABLES.f90:925-930),
  by adaptive quadrature; each integrand evaluation is one batched
  k-inversion on the solver's device.
* finite T: the Matsubara sum up to n_max ~ beta*(max_exc + 2*hwband)/pi
  plus the residual contour integral over the circle |z| = R (the
  reference's scheme, ED_OBSERVABLES.f90:836-870), G evaluated at the true
  complex frequency as the JAX package does.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .bath import basis_lso_of, invg0_bath_lso
from .gf import evaluate_gf_nnn
from .utils.reshape import nnn2lso


@dataclass
class _Item:
    name: str
    sij: np.ndarray            # [Nk, n, n] (k-dependent) weight matrix
    value: float = 0.0


class CustomObservables:
    """init/add/get/clear_custom_observables equivalent, bound to a solved
    :class:`~.solver.EDSolver` (it needs the GF poles and the bath); the
    k-sums run on the solver's device."""

    def __init__(self, solver, hk: np.ndarray):
        self.solver = solver
        self.hk = np.asarray(hk)
        self._hk_dev = torch.as_tensor(
            np.asarray(hk, np.complex128)).to(solver.device)
        self.items: List[_Item] = []

    def add(self, name: str, sij: np.ndarray) -> None:
        """sij: [n, n] (the same for every k) or [Nk, n, n] (or the
        reference's k-last [n, n, Nk])."""
        sij = np.asarray(sij, dtype=np.complex128)
        if sij.ndim == 2:
            sij = np.broadcast_to(sij, self.hk.shape).copy()
        if sij.shape != self.hk.shape and \
                sij.shape == (self.hk.shape[1], self.hk.shape[2],
                              self.hk.shape[0]):
            sij = np.moveaxis(sij, -1, 0)
        self.items.append(_Item(name, sij))

    # -- Sigma(z) at arbitrary z from the stored spectrum ----------------
    def _sigma_lso(self, z: np.ndarray) -> torch.Tensor:
        s = self.solver
        cfg, dev = s.cfg, s.device
        g = evaluate_gf_nnn(s.gf.spectrum, cfg, z)
        g_lso = np.moveaxis(nnn2lso(g, cfg.nlat, cfg.nspin, cfg.norb), -1, 0)
        hloc_lso = nnn2lso(np.asarray(s.imp_hloc, np.complex128), cfg.nlat,
                           cfg.nspin, cfg.norb)
        invg0 = invg0_bath_lso(
            torch.as_tensor(np.asarray(z, np.complex128)).to(dev),
            torch.as_tensor(np.ascontiguousarray(hloc_lso)).to(dev),
            cfg.xmu, torch.as_tensor(s.bath.v).to(dev),
            torch.as_tensor(s.bath.lam).to(dev), basis_lso_of(cfg, s.hb, dev))
        return invg0 - torch.linalg.inv(
            torch.as_tensor(np.ascontiguousarray(g_lso)).to(dev))

    def _ksum(self, z: np.ndarray, sij: np.ndarray,
              subtract_tail: bool) -> np.ndarray:
        """sum_k Re Tr[S_k G_k(z)] / Nk for each z: [L] real."""
        cfg, dev = self.solver.cfg, self.solver.device
        sigma = self._sigma_lso(z)                    # [L, n, n]
        n = self.hk.shape[-1]
        eye = torch.eye(n, dtype=torch.complex128, device=dev)
        zt = torch.as_tensor(np.asarray(z, np.complex128)).to(dev)
        a = ((zt[:, None, None] + cfg.xmu) * eye - sigma)[:, None] \
            - self._hk_dev[None]
        gk = torch.linalg.inv(a)                      # [L, Nk, n, n]
        tr = torch.einsum("kab,lkba->lk", torch.as_tensor(sij).to(dev), gk)
        out = tr.real.mean(dim=1).cpu().numpy()
        if subtract_tail:
            out = out - np.real(np.trace(sij, axis1=1, axis2=2).mean()
                                / (-1.1 + 1j * np.imag(z)))
        return out

    def compute(self) -> Dict[str, float]:
        from scipy.integrate import quad
        cfg = self.solver.cfg
        spin_mult = 3.0 - cfg.nspin
        out: Dict[str, float] = {}
        for item in self.items:
            if not cfg.finite_temp:
                def f(w):
                    return float(self._ksum(np.array([1j * w]), item.sij,
                                            subtract_tail=True)[0])
                val, _ = quad(f, 0.0, np.inf, limit=120)
                val = spin_mult * val / np.pi
            else:
                max_exc = self.solver.gf.max_exc
                nmax = int(2 * (abs(max_exc) + 2 * cfg.hwband)
                           * cfg.beta / np.pi)
                nmax = nmax // 2 if nmax % 2 == 0 else (nmax + 1) // 2
                radius = 2 * (nmax + 1) * np.pi / cfg.beta
                wn = (2 * np.arange(nmax + 1) + 1) * np.pi / cfg.beta
                ms = self._ksum(1j * wn, item.sij, subtract_tail=False)
                val = 2.0 / cfg.beta * ms.sum()

                def contour(theta):
                    w = radius * np.exp(1j * theta)
                    arg = cfg.beta * np.real(w - cfg.xmu)
                    fermi = 0.0 if arg >= 100 else \
                        1.0 / (np.exp(cfg.beta * (w - cfg.xmu)) + 1.0)
                    g = self._ksum(np.array([w]), item.sij,
                                   subtract_tail=False)[0]
                    return float(np.real(w * fermi * g) / np.pi)

                ipart, _ = quad(contour, -np.pi, np.pi, limit=80)
                val = spin_mult * (val + ipart)
            item.value = float(val)
            out[item.name] = item.value
        return out

    def write(self, path: Optional[str] = None) -> None:
        path = path or os.path.join(self.solver.cfg.work_dir,
                                    "custom_observables_last.ed")
        with open(path, "w") as fh:
            for item in self.items:
                fh.write(f"{item.name} {item.value:24.15e}\n")
