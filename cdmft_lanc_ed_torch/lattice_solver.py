"""Real-space CDMFT: several inequivalent clusters.

Port of the JAX package's ``lattice_solver.py`` (the reference's
``ed_init_solver_lattice`` / ``ed_solve_lattice``, ED_MAIN.f90:287-374):
``Nineq`` inequivalent clusters are solved per DMFT iteration, each an
independent impurity problem with its own bath and, optionally, its own
local interaction (the reference's per-site ``Uloc_ii``).  Each cluster is
an :class:`~.solver.EDSolver` on the same device whose files carry the
``_ineq%04d`` suffix; the clusters are solved one after the other, as the
reference and the JAX package do (ED_MAIN.f90:292,314,337).
"""
from __future__ import annotations

import copy
import time
from typing import List, Optional

import numpy as np

from .config import EDConfig
from .device import resolve_device
from .fit import chi2_fitgf
from .solver import EDSolver


class LatticeSolver:
    """ed_*_lattice equivalent over Nineq inequivalent clusters.

    ``device=None`` is the card (raises without CUDA); pass
    ``device="cpu"`` to run on the CPU."""

    def __init__(self, cfg: EDConfig, nineq: int,
                 uloc_ii: Optional[np.ndarray] = None,
                 xmu_ii: Optional[np.ndarray] = None, device=None):
        self.nineq = nineq
        self.device = resolve_device(device)
        self.solvers: List[EDSolver] = []
        self.solve_seconds: List[float] = []
        for ineq in range(nineq):
            c = copy.deepcopy(cfg)
            c.ed_file_suffix = f"_ineq{ineq + 1:04d}"
            if uloc_ii is not None:
                c.uloc = list(np.atleast_2d(uloc_ii)[ineq])
            if xmu_ii is not None:
                c.xmu = float(np.asarray(xmu_ii)[ineq])
            self.solvers.append(EDSolver(c, device=self.device))

    def set_hbath(self, basis, lambdas_ineq) -> None:
        """lambdas_ineq: [Nineq, Nbath, Nsym] (or shared [Nbath, Nsym])."""
        lam = np.asarray(lambdas_ineq, dtype=np.float64)
        if lam.ndim == 2:
            lam = np.tile(lam, (self.nineq, 1, 1))
        for ineq, s in enumerate(self.solvers):
            s.set_hbath(basis, lam[ineq])

    def init_solver(self) -> np.ndarray:
        """Returns the stacked bath array [Nineq, Nb]."""
        return np.stack([s.init_solver() for s in self.solvers])

    def solve(self, bath_ineq: np.ndarray, hloc_ineq: np.ndarray) -> None:
        """hloc_ineq: [Nineq, ...nnn...] (or one shared hloc).  Each
        cluster's wall seconds go to ``solve_seconds``."""
        hloc = np.asarray(hloc_ineq)
        if hloc.ndim == 6:
            hloc = np.broadcast_to(hloc, (self.nineq,) + hloc.shape)
        self.solve_seconds = []
        for ineq, s in enumerate(self.solvers):
            t0 = time.time()
            s.solve(bath_ineq[ineq], hloc[ineq])
            self.solve_seconds.append(time.time() - t0)

    def fit(self, weiss_ineq: np.ndarray, bath_ineq: np.ndarray,
            hloc_ineq: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-cluster chi^2 bath fit (ed_chi2_fitgf lattice wrapper,
        ED_FIT_CHI2.f90:88-111)."""
        out = []
        for ineq, s in enumerate(self.solvers):
            hloc = None
            if hloc_ineq is not None:
                h = np.asarray(hloc_ineq)
                hloc = h[ineq] if h.ndim == 7 else h
            b, _, _ = chi2_fitgf(s.cfg, s.hb, weiss_ineq[ineq],
                                 bath_ineq[ineq], hloc_nnn=hloc,
                                 device=self.device)
            out.append(b)
        return np.stack(out)

    # -- stacked getters (*_ineq arrays, ED_MAIN.f90:357-370) -----------
    def _stack(self, getter: str) -> np.ndarray:
        return np.stack([getattr(s, getter)() for s in self.solvers])

    def sigma_matsubara(self) -> np.ndarray:
        return self._stack("sigma_matsubara")

    def sigma_realaxis(self) -> np.ndarray:
        return self._stack("sigma_realaxis")

    def gimp_matsubara(self) -> np.ndarray:
        return self._stack("gimp_matsubara")

    def gimp_realaxis(self) -> np.ndarray:
        return self._stack("gimp_realaxis")

    def g0imp_matsubara(self) -> np.ndarray:
        return self._stack("g0imp_matsubara")

    def g0imp_realaxis(self) -> np.ndarray:
        return self._stack("g0imp_realaxis")

    def dens(self) -> np.ndarray:
        return self._stack("dens")

    def docc(self) -> np.ndarray:
        return self._stack("docc")

    def mag(self) -> np.ndarray:
        return self._stack("mag")

    def egs(self) -> np.ndarray:
        return np.array([s.egs for s in self.solvers])

    def eimp(self) -> np.ndarray:
        """[Nineq, 4]: (epot, eint, ehartree, eknot), the ed_get_eimp
        lattice layout (ED_MAIN.f90:365); eint is epot - ehartree (the
        reference never assigns it)."""
        return np.array([[s.energy.epot,
                          s.energy.epot - s.energy.ehartree,
                          s.energy.ehartree, s.energy.eknot]
                         for s in self.solvers])

    def doubles(self) -> np.ndarray:
        """[Nineq, 4]: (dust, dund, dse, dph) (ed_get_doubles lattice)."""
        return np.array([[s.energy.dust, s.energy.dund, s.energy.dse,
                          s.energy.dph] for s in self.solvers])

    def cluster_dm(self) -> np.ndarray:
        """[Nineq, 4^Nimp, 4^Nimp] (ed_get_cluster_dm lattice)."""
        return self._stack("cluster_dm")

    def reduced_dm(self, orbital_mask) -> np.ndarray:
        """[Nineq, ...] partial-traced DMs (ed_get_reduced_dm lattice)."""
        return np.stack([s.reduced_dm(orbital_mask)
                         for s in self.solvers])

    def sp_dm(self) -> np.ndarray:
        """[Nineq, ...] single-particle DMs (ed_get_sp_dm lattice)."""
        return self._stack("sp_dm")

    # -- readers (ed_read_impSigma / ed_read_impG lattice variants,
    # ED_IO.f90:661-687,719-744) ----------------------------------------
    def read_impsigma(self) -> np.ndarray:
        """Read every cluster's impSigma files back into its solver;
        returns the stacked [Nineq, ...] Matsubara array."""
        for s in self.solvers:
            s.read_impsigma()
        return self.sigma_matsubara()

    def read_impg(self) -> np.ndarray:
        """Restart-from-G: read every cluster's impG files back."""
        for s in self.solvers:
            s.read_impg()
        return self.gimp_matsubara()
