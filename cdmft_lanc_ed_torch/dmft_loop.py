"""Reusable CDMFT self-consistency loop (port of the JAX package's
``dmft_loop.py``; the reference keeps it in each driver,
drivers/cdn_hm_2dsquare.f90:119-198):

    solve -> Sigma -> G_loc(k-sum) -> Weiss/Delta -> chi2 fit -> mix ->
    convergence / mu-search -> repeat

Everything runs on the solver's device.  With ``nread != 0`` the
chemical-potential search moves ``cfg.xmu`` after each iteration; the
next solve builds its sector operators at the new mu.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from . import bath as bath_mod
from .fit import chi2_fitgf
from .lattice import ConvergenceCheck, MuSearch, dmft_gloc_matsubara, \
    dmft_self_consistency
from .solver import EDSolver


@dataclass
class DMFTResult:
    converged: bool
    iterations: int
    error: float
    bath: np.ndarray
    solver: EDSolver
    gloc: np.ndarray
    weiss: np.ndarray


def run_dmft_loop(solver: EDSolver, hk: np.ndarray, hloc_nnn: np.ndarray,
                  bath, wmixing: float = 0.5,
                  log: Callable[[str], None] = lambda s: None,
                  max_loops: Optional[int] = None,
                  adaptive_mixing: bool = False) -> DMFTResult:
    """Run the DMFT loop until convergence (driver loop equivalent,
    drivers/cdn_hm_2dsquare.f90:119-198).

    ``adaptive_mixing`` reproduces the cdn_bhz_2d_adaptive_mix variant:
    when the self-consistency error grows, the mixing weight is halved;
    after two consecutive improvements it relaxes back toward the
    initial value."""
    cfg = solver.cfg
    device = solver.device
    nloop = max_loops if max_loops is not None else cfg.nloop
    conv = ConvergenceCheck(cfg.dmft_error, cfg.nsuccess)
    mu_search = MuSearch(cfg.nread, cfg.ndelta, cfg.nerr,
                         niter=max(1, cfg.nloop // 3),
                         work_dir=cfg.work_dir,
                         suffix=cfg.ed_file_suffix) \
        if cfg.nread != 0.0 else None
    bath = bath_mod.pack_dmft_bath(cfg, bath_mod.unpack_dmft_bath(cfg, bath))
    bath_prev = None
    gloc = weiss = None
    err = np.inf
    it = 0
    wmix0 = wmixing
    prev_err = np.inf
    improve_streak = 0

    for it in range(1, nloop + 1):
        log(f"DMFT loop {it}/{nloop}")
        solver.solve(bath, hloc_nnn)
        smats = solver.sigma_matsubara()

        gloc = dmft_gloc_matsubara(cfg, hk, smats, device=device)
        weiss = dmft_self_consistency(cfg, gloc, smats, hloc_nnn,
                                      scheme=cfg.cg_scheme, device=device)
        bath_new, chi2, _ = chi2_fitgf(cfg, solver.hb, weiss, bath,
                                       hloc_nnn=hloc_nnn, log=log,
                                       device=device)
        # linear bath mixing (driver :167)
        if bath_prev is not None:
            bath_new = wmixing * bath_new + (1 - wmixing) * bath_prev
        bath_prev = bath_new.copy()
        bath = bath_new

        # persist the fitted bath for crash/restart continuation
        bath_mod.save_dmft_bath(
            cfg, bath_mod.unpack_dmft_bath(cfg, bath),
            os.path.join(cfg.work_dir,
                         cfg.hfile + cfg.ed_file_suffix + ".restart"))

        done = conv(weiss.ravel())
        err = conv.error
        log(f"  error={err:.3e} chi2={chi2:.3e} "
            f"dens={solver.dens().sum():.6f} egs={solver.egs:.8f}")

        if adaptive_mixing and np.isfinite(prev_err):
            if err > prev_err:
                wmixing = max(0.05, 0.5 * wmixing)
                improve_streak = 0
                log(f"  adaptive mixing -> {wmixing:.3f}")
            else:
                improve_streak += 1
                if improve_streak >= 2 and wmixing < wmix0:
                    wmixing = min(wmix0, 1.5 * wmixing)
                    improve_streak = 0
        prev_err = err

        if mu_search is not None:
            dens = float(solver.dens().sum())
            new_mu, done = mu_search.step(cfg.xmu, dens, converged=done)
            if new_mu != cfg.xmu:
                log(f"  mu: {cfg.xmu:.6f} -> {new_mu:.6f} (n={dens:.6f})")
                cfg.xmu = new_mu
        if done:
            return DMFTResult(True, it, err, bath, solver, gloc, weiss)
    return DMFTResult(False, it, err, bath, solver, gloc, weiss)
