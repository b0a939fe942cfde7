"""Solver facade: ed_init_solver / ed_solve.

Port of the JAX package's ``solver.py`` (ED_MAIN.f90, single-cluster path).
The solver holds the configuration, the bath basis, the device and the
latest results; the diagonalization and GF stages run on the device.

At the end of a solve it writes the restart and bookkeeping files the loop
reads back (``state_list.ed``, ``<hfile>.used``, ``timings.ed``,
``eigenvalues_list.ed``) and, through :mod:`.io`, the reference-format
files: ``impSigma``/``impG``/``impG0`` under the ``ed_print_*`` flags, the
observables, energies, ``zeta``/``sig`` and the cluster density matrix.
Every file goes to ``cfg.work_dir``.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from . import bath as bath_mod
from . import io as ed_io
from .bath import BathBasis, DmftBath
from .config import EDConfig
from .device import resolve_device
from .diag import DiagState, diagonalize_impurity
from .gf import (GFResult, GFSpectrum, build_gf_and_sigma, evaluate_gf_nnn,
                 matsubara_grid, realaxis_grid)
from .observables import EnergyTerms, Observables, cluster_density_matrix, \
    local_energy_impurity, observables_impurity, \
    single_particle_density_matrix
from .ops import sector_ham
from .utils.reshape import assert_nnn_shape
from .utils.timer import Timers


class EDSolver:
    """One impurity+bath cluster solver instance.

    Usage (mirrors the reference driver flow, drivers/cdn_hm_2dsquare.f90):

        solver = EDSolver(cfg)                           # on the card
        solver.set_hbath(hsym_basis, lambdasym)          # ed_set_Hbath
        bath = solver.init_solver()                      # ed_init_solver
        solver.solve(bath, hloc)                         # ed_solve
        smats = solver.sigma_matsubara()                 # ed_get_sigma

    ``device=None`` is the card (raises without CUDA); pass
    ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, cfg: EDConfig, device=None):
        self.cfg = cfg.validate()
        self.device = resolve_device(device)
        self.hb: Optional[BathBasis] = None
        self.bath: Optional[DmftBath] = None
        self.imp_hloc: Optional[np.ndarray] = None
        self.diag_state: Optional[DiagState] = None
        self.gf: Optional[GFResult] = None
        self.obs: Optional[Observables] = None
        self.energy: Optional[EnergyTerms] = None
        self.cdm: Optional[np.ndarray] = None
        self.spdm: Optional[np.ndarray] = None
        self.timers: Optional[Timers] = None
        self.verbose_log: Callable[[str], None] = (
            (lambda s: print(s, flush=True)) if cfg.ed_verbose >= 2
            else (lambda s: None))

    # -- bath setup (ed_set_Hbath, ED_BATH.f90:41-58) -------------------
    def set_hbath(self, basis, lambdas) -> None:
        self.hb = bath_mod.set_hbath(basis, lambdas, self.cfg)

    def set_hbath_from_hloc(self, hloc) -> None:
        self.hb = bath_mod.hbath_basis_from_hloc(hloc, self.cfg)

    def get_bath_dimension(self) -> int:
        if self.hb is None:
            raise RuntimeError("call set_hbath first")
        return bath_mod.get_bath_dimension(self.cfg, self.hb.nsym)

    # -- init (ed_init_solver, ED_MAIN.f90:53-184) ----------------------
    def init_solver(self, bath_array=None) -> np.ndarray:
        cfg = self.cfg
        if self.hb is None:
            if cfg.nbath == 0:     # bath-less cluster ED
                self.hb = BathBasis(
                    basis=np.zeros((0, cfg.nlat, cfg.nlat, cfg.nspin,
                                    cfg.nspin, cfg.norb, cfg.norb),
                                   np.complex128),
                    init_lambda=np.zeros((0, 0)))
            else:
                raise RuntimeError("call set_hbath before init_solver")
        if bath_array is not None and not bath_mod.check_bath_dimension(
                cfg, self.hb.nsym, bath_array):
            raise ValueError("wrong bath dimensions")
        restart = os.path.join(cfg.work_dir,
                               cfg.hfile + cfg.ed_file_suffix + ".restart")
        self.bath = bath_mod.init_dmft_bath(cfg, self.hb, restart)
        self.diag_state = DiagState(cfg)
        self.diag_state.load_state_list_restart(
            os.path.join(cfg.work_dir,
                         "state_list" + cfg.ed_file_suffix + ".restart"))
        return bath_mod.pack_dmft_bath(cfg, self.bath)

    # -- sector Hamiltonian factory -------------------------------------
    def _sector_builder(self):
        cfg = self.cfg
        hrec = bath_mod.bath_h_rec(cfg, self.hb, self.bath)
        dhyb = bath_mod.diag_hybr_of(cfg, self.bath)
        hloc = self.imp_hloc

        def build(nup: int, ndw: int) -> sector_ham.SectorOperator:
            return sector_ham.build_sector_operator(
                cfg, hloc, hrec, dhyb, nup, ndw)

        return build

    # -- solve (ed_solve, ED_MAIN.f90:195-282) --------------------------
    def solve(self, bath_array, hloc_nnn: np.ndarray) -> None:
        cfg = self.cfg
        timers = Timers(self.verbose_log if cfg.ed_verbose >= 3 else None)
        with timers.active():
            self._solve(timers, bath_array, hloc_nnn)

    def _solve(self, timers: Timers, bath_array, hloc_nnn) -> None:
        cfg = self.cfg
        assert_nnn_shape(np.asarray(hloc_nnn), cfg.nlat, cfg.nspin, cfg.norb,
                         "Hloc")
        self.imp_hloc = np.asarray(hloc_nnn, dtype=np.complex128)
        if self.hb is not None and not bath_mod.check_bath_dimension(
                cfg, self.hb.nsym, bath_array):
            raise ValueError("wrong bath dimensions")
        self.bath = bath_mod.unpack_dmft_bath(cfg, bath_array)
        bath_mod.save_dmft_bath(cfg, self.bath, os.path.join(
            cfg.work_dir, cfg.hfile + cfg.ed_file_suffix + ".used"))
        if self.diag_state is None:
            self.diag_state = DiagState(cfg)
        self.timers = timers

        build = self._sector_builder()
        with timers("diagonalization"):
            diagonalize_impurity(self.diag_state, build, self.device,
                                 log=self.verbose_log)
        self.diag_state.state_list.save(
            os.path.join(cfg.work_dir,
                         "state_list" + cfg.ed_file_suffix + ".ed"), cfg.ns)

        if cfg.gf_flag:
            with timers("greens_functions"):
                gf = build_gf_and_sigma(cfg, self.hb, self.bath,
                                        self.imp_hloc, self.diag_state,
                                        build, self.device,
                                        log=self.verbose_log)
            # the previous solve's result is released outside the stage
            self.gf = gf
        with timers("observables"):
            self.obs = observables_impurity(cfg, self.diag_state)
            self.energy = local_energy_impurity(cfg, self.imp_hloc,
                                                self.diag_state)
        if cfg.dm_flag:
            with timers("density_matrices"):
                self.cdm = cluster_density_matrix(cfg, self.diag_state)
                self.spdm = single_particle_density_matrix(cfg,
                                                           self.diag_state)
        timers.write(os.path.join(cfg.work_dir,
                                  "timings" + cfg.ed_file_suffix + ".ed"))

        # text-file output (ed_print_* flags; ED_MAIN.f90 print stage)
        if cfg.gf_flag and cfg.ed_print_sigma:
            ed_io.print_impsigma(cfg, self.gf)
        if cfg.gf_flag and cfg.ed_print_g:
            ed_io.print_impg(cfg, self.gf)
        if cfg.gf_flag and cfg.ed_print_g0:
            ed_io.print_impg0(cfg, self.gf)
        ed_io.write_observables(cfg, self.obs, self.egs, cfg.ed_file_suffix)
        ed_io.write_energy(cfg, self.energy)
        if cfg.gf_flag:
            ed_io.write_zeta_and_sig(cfg, self.gf.smats)
        if cfg.dm_flag and self.cdm is not None:
            ed_io.print_cluster_dm(cfg, self.cdm)

    # -- getters (ED_IO.f90:241-289 equivalents) ------------------------
    @property
    def egs(self) -> float:
        return self.diag_state.state_list.emin

    def sigma_matsubara(self) -> np.ndarray:
        return self.gf.smats

    def sigma_realaxis(self) -> np.ndarray:
        return self.gf.sreal

    def gimp_matsubara(self) -> np.ndarray:
        return self.gf.gmats

    def gimp_realaxis(self) -> np.ndarray:
        return self.gf.greal

    def g0imp_matsubara(self) -> np.ndarray:
        return self.gf.g0mats

    def g0imp_realaxis(self) -> np.ndarray:
        return self.gf.g0real

    def dens(self) -> np.ndarray:
        return self.obs.dens

    def docc(self) -> np.ndarray:
        return self.obs.docc

    def mag(self) -> np.ndarray:
        return self.obs.magz

    def cluster_dm(self) -> Optional[np.ndarray]:
        return self.cdm

    def sp_dm(self) -> Optional[np.ndarray]:
        return self.spdm

    def _ensure_gf_store(self) -> GFResult:
        """An empty GFResult shell for reader-populated functions (the
        reference readers fill the global impSmats/impGmats arrays
        without a solve, ED_IO.f90:626-744)."""
        if self.gf is None:
            cfg = self.cfg
            shape_m = (cfg.nlat, cfg.nlat, cfg.nspin, cfg.nspin,
                       cfg.norb, cfg.norb, cfg.lmats)
            shape_r = shape_m[:-1] + (cfg.lreal,)
            z = np.zeros
            self.gf = GFResult(
                spectrum=GFSpectrum(),
                gmats=z(shape_m, np.complex128),
                greal=z(shape_r, np.complex128),
                smats=z(shape_m, np.complex128),
                sreal=z(shape_r, np.complex128),
                g0mats=z(shape_m, np.complex128),
                g0real=z(shape_r, np.complex128),
                max_exc=0.0, wm=matsubara_grid(cfg),
                wr=realaxis_grid(cfg))
        return self.gf

    def read_impsigma(self) -> None:
        """ed_read_impSigma: restore Sigma(iw)/Sigma(w) from printed files
        into the solver store (served by the sigma_* getters)."""
        gf = self._ensure_gf_store()
        gf.smats, gf.sreal = ed_io.read_impsigma(self.cfg)

    def read_impg(self) -> None:
        """ed_read_impG: restore G(iw)/G(w) from printed files (the
        restart-from-G workflow, ED_IO.f90:689-744)."""
        gf = self._ensure_gf_store()
        gf.gmats, gf.greal = ed_io.read_impg(self.cfg)

    def gf_cluster(self, z: np.ndarray) -> np.ndarray:
        """Cluster GF at arbitrary complex frequencies from the stored
        pole/weight spectrum (ed_gf_cluster, ED_IO/gf_cluster.f90)."""
        return evaluate_gf_nnn(self.gf.spectrum, self.cfg, np.asarray(z))

    def reduced_dm(self, orbital_mask) -> np.ndarray:
        """ed_get_reduced_dm: partial trace of the cluster DM."""
        if self.cdm is None:
            self.cdm = cluster_density_matrix(self.cfg, self.diag_state)
        return ed_io.get_reduced_dm(self.cfg, self.cdm, orbital_mask)
