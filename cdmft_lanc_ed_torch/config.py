"""Input/config system.

Copy of the JAX package's input layer, itself a re-implementation of the
reference input layer
(/root/reference/ED_INPUT_VARS.f90:103-234): every input variable of the
reference solver is kept, with the same (lower-cased) name and the same
default, parsed from the same ``NAME=value`` input-file format produced by
SciFortran's SF_PARSE_INPUT.  Unlike the reference (mutable module globals)
the configuration is an explicit dataclass passed to the solver.
"""
from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import List, Optional


def _default_uloc() -> List[float]:
    return [2.0, 0.0, 0.0, 0.0, 0.0]


@dataclass
class EDConfig:
    # --- problem size (ED_INPUT_VARS.f90:124-128) ---
    nlat: int = 1             # number of cluster sites
    norb: int = 1             # impurity orbitals per site (max 5)
    nspin: int = 1            # spin degeneracy (max 2)
    nbath: int = 6            # number of bath replicas
    bath_type: str = "replica"  # 'replica' | 'general'

    # --- interaction (ED_INPUT_VARS.f90:129-133) ---
    uloc: List[float] = field(default_factory=_default_uloc)
    ust: float = 0.0
    jh: float = 0.0
    jx: float = 0.0
    jp: float = 0.0

    # --- thermodynamics / loop control (ED_INPUT_VARS.f90:134-140) ---
    beta: float = 1000.0
    xmu: float = 0.0
    nloop: int = 100
    dmft_error: float = 1e-5
    sb_field: float = 0.1
    gf_flag: bool = True
    dm_flag: bool = False

    # --- sector control (ED_INPUT_VARS.f90:142-150) ---
    ed_twin: bool = False
    ed_sectors: bool = False
    ed_sectors_shift: int = 1
    ed_sparse_h: bool = True
    ed_gf_symmetric: bool = False
    ed_print_sigma: bool = True
    ed_print_g: bool = True
    ed_print_g0: bool = True
    ed_verbose: int = 3

    # --- frequency grids (ED_INPUT_VARS.f90:152-168) ---
    nsuccess: int = 1
    lmats: int = 5000
    lreal: int = 5000
    ltau: int = 1000
    lfit: int = 1000
    nread: float = 0.0
    nerr: float = 1e-4
    ndelta: float = 0.1
    ncoeff: float = 1.0
    wini: float = -5.0
    wfin: float = 5.0
    chiflag: bool = False
    hfmode: bool = True
    eps: float = 0.01
    cutoff: float = 1e-9
    gs_threshold: float = 1e-9
    hwband: float = 2.0

    # --- Lanczos control (ED_INPUT_VARS.f90:170-179) ---
    lanc_method: str = "arpack"
    lanc_nstates_sector: int = 2
    lanc_nstates_total: int = 1
    lanc_nstates_step: int = 2
    lanc_ncv_factor: int = 10
    lanc_ncv_add: int = 0
    lanc_niter: int = 512
    lanc_ngfiter: int = 200
    lanc_tolerance: float = 1e-18
    lanc_dim_threshold: int = 1024

    # --- chi^2 fit control (ED_INPUT_VARS.f90:181-192) ---
    cg_method: int = 1
    cg_grad: int = 1
    cg_ftol: float = 1e-5
    cg_stop: int = 0
    cg_niter: int = 500
    cg_weight: int = 1
    cg_matrix: int = 1
    cg_scheme: str = "weiss"
    cg_norm: str = "elemental"
    cg_pow: int = 2
    cg_minimize_ver: bool = False
    cg_minimize_hh: float = 1e-4

    # --- files / logging (ED_INPUT_VARS.f90:193-195) ---
    hfile: str = "hamiltonian"
    hlocfile: str = "inputHLOC.in"
    logfile: int = 6

    # --- framework-specific knobs (new; no reference counterpart) ---
    ed_file_suffix: str = ""     # suffix attached to restart/output files
    ed_precision: str = "complex128"   # device dtype for eigensolves
    ed_gf_precision: str = "double"    # GF tridiag dtype: double|single
    # mixed path: relative residual at which refined eigenVECTORS are
    # accepted (they feed Sigma; eigenvalue error ~ resid^2/gap).  0.0
    # means auto (1e-10, or the CDMFT_MIXED_RTOL env override).
    ed_mixed_vec_tol: float = 0.0
    work_dir: str = "."          # directory for restart/output text files

    # ------------------------------------------------------------------
    # derived quantities (reference: ED_SETUP.f90:111-120)
    # ------------------------------------------------------------------
    @property
    def nimp(self) -> int:
        return self.nlat * self.norb

    @property
    def ns(self) -> int:
        return self.nimp * (self.nbath + 1)

    @property
    def nlso(self) -> int:
        return self.nlat * self.nspin * self.norb

    @property
    def nsectors(self) -> int:
        return (self.ns + 1) ** 2

    @property
    def finite_temp(self) -> bool:
        # reference: ED_SETUP.f90:174-178
        return self.lanc_nstates_total != 1

    @property
    def jhflag(self) -> bool:
        # reference: ED_SETUP.f90:200-201
        return self.norb > 1 and (self.jx != 0.0 or self.jp != 0.0)

    @property
    def uloc_arr(self):
        import numpy as np
        u = np.zeros(self.norb)
        for i in range(min(self.norb, len(self.uloc))):
            u[i] = self.uloc[i]
        return u

    def validate(self) -> "EDConfig":
        """Sanity checks mirroring ed_checks_global (ED_SETUP.f90:85-101)."""
        if self.nspin > 2:
            raise ValueError("nspin > 2 is not supported")
        if self.norb > 5:
            raise ValueError("norb > 5 is not supported")
        if self.bath_type not in ("replica", "general"):
            raise ValueError(f"unknown bath_type '{self.bath_type}'")
        if self.ed_gf_precision not in ("double", "single"):
            raise ValueError(
                f"ed_gf_precision must be 'double' or 'single', "
                f"got '{self.ed_gf_precision}'")
        if self.ed_precision not in ("complex128", "mixed"):
            raise ValueError(
                f"ed_precision must be 'complex128' or 'mixed', "
                f"got '{self.ed_precision}'")
        if self.lfit > self.lmats:
            self.lfit = self.lmats
        if self.lanc_method == "lanczos" and self.lanc_nstates_total > 1:
            raise ValueError("lanc_method=lanczos requires lanc_nstates_total==1 (T=0)")
        self.ltau = max(int(self.beta), self.ltau)
        return self


# ---------------------------------------------------------------------------
# Input-file parsing: same "NAME=value" format as SF_PARSE_INPUT
# ---------------------------------------------------------------------------

_BOOL_TRUE = {"t", ".true.", "true", "1", "yes"}
_BOOL_FALSE = {"f", ".false.", "false", "0", "no"}


def _parse_scalar(raw: str, pytype):
    raw = raw.strip()
    if pytype is bool:
        low = raw.lower()
        if low in _BOOL_TRUE:
            return True
        if low in _BOOL_FALSE:
            return False
        raise ValueError(f"cannot parse boolean from '{raw}'")
    if pytype is int:
        return int(float(raw.replace("d", "e").replace("D", "E")))
    if pytype is float:
        return float(raw.replace("d", "e").replace("D", "E"))
    return raw.strip("'\"")


def read_input(path: Optional[str] = None, comm=None, **overrides) -> EDConfig:
    """Build an :class:`EDConfig` from a reference-format input file.

    Mirrors ``ed_read_input`` (ED_INPUT_VARS.f90:103-234): accepted lines are
    ``NAME=value  !comment``; unknown names are ignored (drivers share the
    file); values in Fortran D-exponent form are handled.  Keyword overrides
    win over file contents.  Also honours ``xmu.restart`` when nread/=0
    (ED_INPUT_VARS.f90:219-228).
    """
    cfg = EDConfig()
    fields = {f.name: f for f in dataclasses.fields(EDConfig)}
    if path and os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                line = line.split("!")[0].split("#")[0].strip()
                if not line or "=" not in line:
                    continue
                name, _, raw = line.partition("=")
                key = name.strip().lower()
                raw = raw.strip()
                if key not in fields:
                    continue
                f = fields[key]
                if f.name == "uloc":
                    vals = [_parse_scalar(v, float)
                            for v in re.split(r"[,\s]+", raw) if v]
                    cfg.uloc = vals
                else:
                    pytype = type(getattr(cfg, key))
                    setattr(cfg, key, _parse_scalar(raw, pytype))
    for k, v in overrides.items():
        k = k.lower()
        if k not in fields:
            raise KeyError(f"unknown input variable '{k}'")
        setattr(cfg, k, v)
    cfg.validate()
    # xmu.restart handling (ED_INPUT_VARS.f90:219-228)
    if cfg.nread != 0.0:
        xmu_restart = os.path.join(cfg.work_dir, "xmu.restart")
        if os.path.exists(xmu_restart):
            with open(xmu_restart) as fh:
                toks = fh.read().split()
            cfg.xmu = float(toks[0])
            cfg.ndelta = abs(float(toks[1])) * cfg.ncoeff
    # Hfile suffix stripping (ED_INPUT_VARS.f90:232-233)
    cfg.hfile = cfg.hfile.replace(".restart", "").replace(".ed", "")
    if path:
        save_input(cfg, path)
    return cfg


def save_input(cfg: EDConfig, path: str) -> None:
    """Write the used input back out (reference saves `used.<input>`)."""
    used = os.path.join(os.path.dirname(os.path.abspath(path)) or ".",
                        "used." + os.path.basename(path))
    try:
        with open(used, "w") as fh:
            for f in dataclasses.fields(cfg):
                v = getattr(cfg, f.name)
                if isinstance(v, bool):
                    sv = "T" if v else "F"
                elif isinstance(v, list):
                    sv = ",".join(str(x) for x in v)
                else:
                    sv = str(v)
                fh.write(f"{f.name.upper()}={sv}\n")
    except OSError:
        pass


ed_read_input = read_input  # reference-compatible alias
