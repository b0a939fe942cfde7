"""Reference-named convenience API.

Port of the JAX package's ``compat.py``: thin aliases mapping the
reference's ``ed_*`` procedure names (CDMFT_ED.f90:4-52,
ED_IO.f90:241-289) onto the object-oriented solver, for users porting
driver scripts verbatim.  The solver instance plays the role of the
reference's global state; the bath functions and the fit run on the
solver's device.
"""
from __future__ import annotations

import numpy as np

from . import bath as _bath
from .fit import chi2_fitgf as _chi2_fitgf
from .solver import EDSolver


def ed_set_hbath(solver: EDSolver, basis, lambdas) -> None:
    solver.set_hbath(basis, lambdas)


def ed_get_bath_dimension(solver: EDSolver) -> int:
    return solver.get_bath_dimension()


def ed_init_solver(solver: EDSolver, bath=None) -> np.ndarray:
    return solver.init_solver(bath)


def ed_solve(solver: EDSolver, bath, hloc) -> None:
    solver.solve(bath, hloc)


def ed_get_sigma_matsubara(solver: EDSolver) -> np.ndarray:
    return solver.sigma_matsubara()


def ed_get_sigma_realaxis(solver: EDSolver) -> np.ndarray:
    return solver.sigma_realaxis()


def ed_get_gimp_matsubara(solver: EDSolver) -> np.ndarray:
    return solver.gimp_matsubara()


def ed_get_gimp_realaxis(solver: EDSolver) -> np.ndarray:
    return solver.gimp_realaxis()


def ed_get_g0imp_matsubara(solver: EDSolver) -> np.ndarray:
    return solver.g0imp_matsubara()


def ed_get_g0imp_realaxis(solver: EDSolver) -> np.ndarray:
    return solver.g0imp_realaxis()


def ed_get_dens(solver: EDSolver) -> np.ndarray:
    return solver.dens()


def ed_get_docc(solver: EDSolver) -> np.ndarray:
    return solver.docc()


def ed_get_mag(solver: EDSolver) -> np.ndarray:
    return solver.mag()


def ed_get_eimp(solver: EDSolver) -> np.ndarray:
    e = solver.energy
    return np.array([e.epot, e.eknot, e.ehartree, 0.0])


def ed_get_doubles(solver: EDSolver) -> np.ndarray:
    e = solver.energy
    return np.array([e.dust, e.dund, e.dse, e.dph])


def ed_get_cluster_dm(solver: EDSolver) -> np.ndarray:
    return solver.cluster_dm()


def ed_get_reduced_dm(solver: EDSolver, orbital_mask) -> np.ndarray:
    return solver.reduced_dm(orbital_mask)


def ed_get_sp_dm(solver: EDSolver) -> np.ndarray:
    return solver.sp_dm()


def ed_gf_cluster(solver: EDSolver, z) -> np.ndarray:
    return solver.gf_cluster(np.atleast_1d(np.asarray(z)))


def ed_chi2_fitgf(solver: EDSolver, fg, bath, hloc=None) -> np.ndarray:
    new_bath, _, _ = _chi2_fitgf(solver.cfg, solver.hb, fg, bath,
                                 hloc_nnn=hloc, device=solver.device)
    return new_bath


def ed_print_impsigma(solver: EDSolver) -> None:
    from . import io as ed_io
    ed_io.print_impsigma(solver.cfg, solver.gf)


def ed_print_impg(solver: EDSolver) -> None:
    from . import io as ed_io
    ed_io.print_impg(solver.cfg, solver.gf)


def ed_print_impg0(solver: EDSolver) -> None:
    from . import io as ed_io
    ed_io.print_impg0(solver.cfg, solver.gf)


def ed_read_impsigma(solver: EDSolver, nineq: int = 0):
    """ed_read_impSigma: single (nineq=0) or [Nineq,...] lattice variant
    (ED_IO.f90:626-687)."""
    from . import io as ed_io
    if nineq:
        return ed_io.read_impsigma_lattice(solver.cfg, nineq)
    return ed_io.read_impsigma(solver.cfg)


def ed_read_impg(solver: EDSolver, nineq: int = 0):
    """ed_read_impG: single (nineq=0) or [Nineq,...] lattice variant
    (ED_IO.f90:689-744)."""
    from . import io as ed_io
    if nineq:
        return ed_io.read_impg_lattice(solver.cfg, nineq)
    return ed_io.read_impg(solver.cfg)


def _bath_fn_grids(solver: EDSolver, axis: str) -> np.ndarray:
    from .gf import matsubara_grid, realaxis_grid
    cfg = solver.cfg
    if axis == "matsubara":
        return 1j * matsubara_grid(cfg)
    return realaxis_grid(cfg) + 1j * cfg.eps


def _bath_state(solver: EDSolver, bath=None):
    b = (solver.bath if bath is None
         else _bath.unpack_dmft_bath(solver.cfg, np.asarray(bath)))
    if solver.hb is None or b is None:
        raise RuntimeError("solver has no bath set (call set_hbath + "
                           "init_solver/solve first)")
    return b


def _hloc_state(solver: EDSolver) -> np.ndarray:
    """g0and/invg0and need the impurity Hloc, which is only set by the
    first solve (ED_MAIN.f90:195-282 sets impHloc inside ed_solve); a
    clear error beats the obscure TypeError nnn2lso raises on None."""
    if solver.imp_hloc is None:
        raise RuntimeError("solver has no impurity Hloc yet — g0and/"
                           "invg0and getters need it; call solve first")
    return solver.imp_hloc


def ed_get_delta_matsubara(solver: EDSolver, bath=None) -> np.ndarray:
    """ed_get_delta_matsubara (ED_IO.f90:250-257): hybridization
    Delta(iw) [Nlat,Nlat,Nspin,Nspin,Norb,Norb,Lmats] from the current
    (or supplied packed) bath."""
    return _bath.delta_bath(solver.cfg, solver.hb,
                            _bath_state(solver, bath),
                            _bath_fn_grids(solver, "matsubara"),
                            device=solver.device)


def ed_get_delta_realaxis(solver: EDSolver, bath=None) -> np.ndarray:
    return _bath.delta_bath(solver.cfg, solver.hb,
                            _bath_state(solver, bath),
                            _bath_fn_grids(solver, "realaxis"),
                            device=solver.device)


def ed_get_g0and_matsubara(solver: EDSolver, bath=None) -> np.ndarray:
    """ed_get_g0and_matsubara: non-interacting impurity G0and(iw) from
    the bath + the last-solved impurity Hloc (ED_BATH_FUNCTIONS.f90:
    102-121)."""
    return _bath.g0and_bath(solver.cfg, solver.hb,
                            _bath_state(solver, bath), _hloc_state(solver),
                            _bath_fn_grids(solver, "matsubara"),
                            device=solver.device)


def ed_get_g0and_realaxis(solver: EDSolver, bath=None) -> np.ndarray:
    return _bath.g0and_bath(solver.cfg, solver.hb,
                            _bath_state(solver, bath), _hloc_state(solver),
                            _bath_fn_grids(solver, "realaxis"),
                            device=solver.device)


def ed_get_invg0and_matsubara(solver: EDSolver, bath=None) -> np.ndarray:
    """ed_get_invG0and_matsubara: G0and^{-1}(iw)
    (ED_BATH_FUNCTIONS.f90:125-155)."""
    return _bath.invg0_bath(solver.cfg, solver.hb,
                            _bath_state(solver, bath), _hloc_state(solver),
                            _bath_fn_grids(solver, "matsubara"),
                            device=solver.device)


def ed_get_invg0and_realaxis(solver: EDSolver, bath=None) -> np.ndarray:
    return _bath.invg0_bath(solver.cfg, solver.hb,
                            _bath_state(solver, bath), _hloc_state(solver),
                            _bath_fn_grids(solver, "realaxis"),
                            device=solver.device)


def ed_spin_symmetrize_bath(solver: EDSolver, bath) -> np.ndarray:
    """Replica/general baths are spin-symmetric by construction when the
    basis matrices are (the reference's routine acts on normal baths);
    provided for API compatibility — returns the bath unchanged."""
    return np.asarray(bath)
