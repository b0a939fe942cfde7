"""Lattice layer: k-grids, local Green's function, DMFT self-consistency.

Port of the JAX package's ``lattice.py`` (replacing the DMFTtools routines
the reference drivers call: ``dmft_gloc_matsubara/realaxis``,
``dmft_self_consistency``, ``check_convergence``, ``dmft_kinetic_energy``,
``TB_build_kgrid``) and of the reference's chemical-potential search
(``MuSearch``, ``VariableSearch``; host state machines).  The (k, omega)
linear algebra is batched complex128 inversion on the device.  Cluster
functions are in 'nnn' shape [Nlat,Nlat,Nspin,Nspin,Norb,Norb,L]; H(k) in
lso shape [Nk, Nlso, Nlso].
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

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


def build_hk(hk_model: Callable[[np.ndarray], np.ndarray],
             kgrid: np.ndarray) -> np.ndarray:
    """Evaluate a k-dependent Bloch Hamiltonian on the grid:
    [Nk, Nlso, Nlso] (TB_build_model replacement)."""
    return np.stack([np.asarray(hk_model(k)) for k in kgrid])


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
                     _hk_tensor(hk, device),
                     _freq_lso(cfg, smats_nnn, device), cfg.xmu)
    return _nnn(cfg, g)


def _hk_tensor(hk: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(hk, np.complex128)).to(device)


def dmft_gloc_realaxis(cfg: EDConfig, hk: np.ndarray, sreal_nnn: np.ndarray,
                       device=None) -> np.ndarray:
    """Real-axis local GF at w + i eps in nnn shape
    (dmft_gloc_realaxis equivalent)."""
    device = resolve_device(device)
    wr = np.linspace(cfg.wini, cfg.wfin, sreal_nnn.shape[-1])
    g = gloc_lattice(torch.as_tensor(wr + 1j * cfg.eps).to(device),
                     _hk_tensor(hk, device),
                     _freq_lso(cfg, sreal_nnn, device), cfg.xmu)
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


# ---------------------------------------------------------------------------
# kinetic energy (dmft_kinetic_energy replacement)
# ---------------------------------------------------------------------------

def dmft_kinetic_energy(cfg: EDConfig, hk: np.ndarray, smats_nnn: np.ndarray,
                        device=None, chunk: int = 256) -> float:
    """E_kin = <H_0> on the lattice.

    Tail-corrected Matsubara sum: the interacting part is summed as
    Tr[H_k (G_k - G0_k)] (fast-decaying) with the inverses in complex128
    on the device, ``chunk`` frequencies at a time; the free part is
    evaluated exactly from the spectrum of H_k with Fermi factors."""
    device = resolve_device(device)
    l = smats_nnn.shape[-1]
    wm = np.pi / cfg.beta * (2 * np.arange(l) + 1)
    z = torch.as_tensor(1j * wm).to(device)
    s_lso = _freq_lso(cfg, smats_nnn, device)
    hk_d = _hk_tensor(hk, device)
    eye = torch.eye(hk_d.shape[-1], dtype=torch.complex128, device=device)
    acc = torch.zeros((), dtype=torch.float64, device=device)
    for i in range(0, l, chunk):
        zc, sc = z[i:i + chunk], s_lso[i:i + chunk]
        g = torch.linalg.inv(
            ((zc[:, None, None] + cfg.xmu) * eye - sc)[:, None] - hk_d[None])
        g0 = torch.linalg.inv(
            ((zc[:, None, None] + cfg.xmu) * eye)[:, None] - hk_d[None])
        acc += torch.einsum("kab,lkba->", hk_d, g - g0).real
    nk = hk.shape[0]
    ekin_int = 2.0 / cfg.beta * float(acc) / nk   # 2/beta: +/- frequencies

    # free part: exact sum Tr[H f(H - mu)]
    evals = np.linalg.eigvalsh(np.asarray(hk))
    occ = 1.0 / (1.0 + np.exp(np.clip(cfg.beta * (evals - cfg.xmu),
                                      -500, 500)))
    ekin_free = float((evals * occ).sum()) / nk

    # spin degeneracy when nspin==1 (paramagnetic convention: per-spin H)
    spin_fac = 2.0 if cfg.nspin == 1 else 1.0
    return spin_fac * (ekin_int + ekin_free)


# ---------------------------------------------------------------------------
# chemical-potential search (search_chemical_potential + ed_search_variable,
# ED_AUX_FUNX.f90:586-853); host state machines, as in the JAX package
# ---------------------------------------------------------------------------

class VariableSearch:
    """ed_search_variable (ED_AUX_FUNX.f90:586-697): secant update of a
    control variable (usually mu) toward a target density using a running
    compressibility estimate ``chich = dvar/dn`` persisted to
    ``var_compressibility.restart`` (and echoed to ``.used``)."""

    def __init__(self, nread: float, nerr: float = 1e-4,
                 ndelta: float = 0.1, work_dir: str = ".",
                 suffix: str = ""):
        self.nread = nread
        self.nerr = nerr
        self.work_dir = work_dir
        self.suffix = suffix
        self.path = os.path.join(work_dir, "var_compressibility.restart")
        self.chich = ndelta              # dvar/dn estimate (init :619)
        self.nold = 0.0
        self.var_old = 0.0
        self.count = 0
        self.totcount = 0
        if os.path.exists(self.path):
            try:
                with open(self.path) as fh:
                    self.chich = float(fh.read().split()[0])
            except (OSError, ValueError, IndexError):
                pass

    def step(self, var: float, ntmp: float,
             converged: bool = True) -> Tuple[float, bool]:
        """Returns (new_var, converged): converged is the DMFT flag in,
        gated on |n - nread| <= nerr out (ED_AUX_FUNX.f90:686)."""
        if self.nread == 0.0:
            return var, converged
        self.count += 1
        self.totcount += 1
        if self.count == 1:
            self.var_old = var
        ndiff = ntmp - self.nread
        self._write(os.path.join(self.work_dir,
                                 "var_compressibility.used"))
        # charge compressibility chich = dvar/dn (:638-641)
        if self.count > 1:
            self.chich = (var - self.var_old) / (ntmp - self.nold + 1e-10)
        if self.chich > 10.0:
            self.chich = 2.0                       # clamp (:644)
        var_new = var - ndiff * self.chich         # (:649)
        self.nold = ntmp
        self.var_old = var
        try:
            with open(os.path.join(
                    self.work_dir, "search_variable_iteration_info"
                    + self.suffix + ".ed"), "a") as fh:
                fh.write(f"{self.totcount} {var_new:.12e} {ntmp:.12e} "
                         f"{ndiff:.12e}\n")
        except OSError:
            pass
        if abs(ndiff) > self.nerr:
            converged = False
        self._write(self.path)
        return var_new, converged

    def _write(self, path: str):
        try:
            with open(path, "w") as fh:
                fh.write(f"{self.chich:.12e}\n")
        except OSError:
            pass


class MuSearch:
    """``search_chemical_potential`` (ED_AUX_FUNX.f90:701-853): fixed-step
    bracketing walk of mu with oscillation-triggered step halving, adaptive
    density-threshold reduction once the DMFT loop has converged at the
    current threshold, and ``xmu.restart`` persistence (read back by
    config.read_input, ED_INPUT_VARS.f90:219-228)."""

    def __init__(self, nread: float, ndelta: float = 0.1,
                 nerr: float = 1e-4, niter: int = 33,
                 work_dir: str = ".", suffix: str = ""):
        self.nread = nread
        self.ndelta = ndelta
        self.nerr = nerr
        self.niter = niter               # = nloop/3 (ED_SETUP.f90:208)
        self.work_dir = work_dir
        self.suffix = suffix
        self.count = 0
        self.totcount = 0
        self.nindex = 0
        self.nindex_hist = [0, 0, 0]     # last 3 nindex values (:746-751)
        self.nth_magnitude = -2
        self.nth_magnitude_old = -2
        self.nth = 1e-2
        self.ireduce = True

    def step(self, var: float, ntmp: float,
             converged: bool = True) -> Tuple[float, bool]:
        """One search iteration; returns (new_mu, converged)."""
        if self.nread == 0.0:
            return var, converged
        ndiff = ntmp - self.nread
        nratio = 0.5
        self.count += 1
        self.totcount += 1
        self.nindex_hist = [self.nindex] + self.nindex_hist[:2]
        if ndiff >= self.nth:
            self.nindex = -1
        elif ndiff <= -self.nth:
            self.nindex = 1
        else:
            self.nindex = 0
        ndelta_old = self.ndelta
        # halve the step when the walk oscillates (:761-766)
        osc = self.nindex != 0 and (
            self.nindex + self.nindex_hist[0] == 0
            or self.nindex + sum(self.nindex_hist) == 0)
        if osc:
            self.ndelta = ndelta_old * nratio
        if abs(ndelta_old) < 1e-9:
            ndelta_old = 0.0
            self.nindex = 0
        var = var + self.nindex * self.ndelta
        try:
            with open(os.path.join(self.work_dir, "search_mu_iteration"
                                   + self.suffix + ".ed"), "a") as fh:
                fh.write(f"{var:.12e} {ntmp:.12e} {ndiff:.12e}\n")
        except OSError:
            pass
        # adaptive threshold reduction once converged at this nth (:803-812)
        if (self.ireduce and abs(ndiff) < self.nth and converged
                and self.nth > self.nerr):
            self.nth_magnitude_old = self.nth_magnitude
            self.nth_magnitude -= 1
            self.nth = max(self.nerr, 10.0 ** self.nth_magnitude)
            self.count = 0
            converged = False
            self.ndelta = ndelta_old * nratio
        if abs(ndiff) > self.nth:
            converged = False
        # give up reducing after too many iterations at one threshold (:823)
        if self.ireduce and self.count > self.niter and not converged:
            self.ireduce = False
            self.nth = 10.0 ** self.nth_magnitude_old
        try:
            with open(os.path.join(self.work_dir, "xmu.restart"),
                      "w") as fh:
                fh.write(f"{var:.12e} {self.ndelta:.12e}\n")
        except OSError:
            pass
        return var, converged
