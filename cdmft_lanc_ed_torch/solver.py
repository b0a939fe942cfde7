"""Solver facade: ed_init_solver / ed_solve.

Port of the JAX package's ``solver.py`` (ED_MAIN.f90, single-cluster path).
The solver holds the configuration, the bath basis, the device and the
latest results; the diagonalization and GF stages run on the device.

The ``ed_print_*`` flags have no effect yet: the reference-format printers
(``io.py``) are a later slice.  The solver still writes the restart and
bookkeeping files the loop reads back (``state_list.ed``,
``<hfile>.used``, ``timings.ed``, ``eigenvalues_list.ed``).
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from . import bath as bath_mod
from .bath import BathBasis, DmftBath
from .config import EDConfig
from .device import resolve_device
from .diag import DiagState, diagonalize_impurity
from .gf import GFResult, build_gf_and_sigma
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

        timers = Timers(self.verbose_log if cfg.ed_verbose >= 3 else None)
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
                self.gf = build_gf_and_sigma(cfg, self.hb, self.bath,
                                             self.imp_hloc, self.diag_state,
                                             build, self.device,
                                             log=self.verbose_log)
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
