"""Sector-sweep diagonalization driver.

Port of the JAX package's ``diag.py`` (dense-factor path): loop over all
(N_up, N_dw) Fock sectors, solve each with the dense path (small dims) or
the thick-restart Lanczos eigensolver, and keep the retained eigenstates in
the capacity-constrained :class:`~.eigenspace.StateList`.  Real sectors
take the real kit, complex ones the complex pair kit.  Same-bucket sectors
of one kind are solved as one batch (one device stream, shared restart
schedule); the rest are solved one by one.  ``ed_precision="mixed"`` runs
the f32 (complex64) Krylov stage on the fused CUDA H·v and refines in f64
(complex128).

Spin factors beyond the dense-factor limit (Ns >= 16) are a later slice of
the port and raise NotImplementedError.
"""
from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .config import EDConfig
from .device import budget_bytes
from .eigenspace import StateList
from .ops import lanczos, sector_ham, split
from .utils import fock

_LARGE_TODO = ("spin factors above the dense-factor limit (Ns >= 16) are "
               "not ported yet (ROADMAP Queue 1 item 7: large sectors)")


@dataclass
class DiagState:
    """Across-solve spectrum bookkeeping (the reference keeps these as
    module globals: neigen_sector, twin_mask, zeta_function, ...)."""
    cfg: EDConfig
    neigen_sector: np.ndarray = field(default=None)
    twin_mask: np.ndarray = field(default=None)
    sectors_mask: np.ndarray = field(default=None)
    lanc_nstates_total: int = 0
    state_list: StateList = field(default_factory=StateList)
    zeta_function: float = 0.0

    def __post_init__(self):
        cfg = self.cfg
        ns, nsec = cfg.ns, cfg.nsectors
        if self.neigen_sector is None:
            # setup_global (ED_SETUP.f90:302-420)
            self.neigen_sector = np.full(nsec, cfg.lanc_nstates_sector,
                                         dtype=np.int64)
        if self.twin_mask is None:
            self.twin_mask = np.ones(nsec, dtype=bool)
            if cfg.ed_twin:
                # solve only nup >= ndw (ED_SETUP.f90:354-365)
                for isec in fock.all_sectors(ns):
                    nup, ndw = fock.get_quantum_numbers(isec, ns)
                    if nup < ndw:
                        self.twin_mask[isec - 1] = False
        if self.sectors_mask is None:
            self.sectors_mask = np.ones(nsec, dtype=bool)
        if self.lanc_nstates_total == 0:
            self.lanc_nstates_total = cfg.lanc_nstates_total

    # -- restart bootstrap (ED_SETUP.f90:325-351) -----------------------
    def load_state_list_restart(self, path: str) -> None:
        if not os.path.exists(path):
            return
        ns = self.cfg.ns
        with open(path) as fh:
            for line in fh:
                toks = line.split()
                if len(toks) >= 4:
                    nup, ndw = int(toks[2]), int(toks[3])
                    isec = fock.get_sector(nup, ndw, ns)
                    self.neigen_sector[isec - 1] += 1

    # -- sector-scan restriction (ed_pre_diag, ED_DIAG.f90:276-323) -----
    def load_sectors_restart(self, path: str) -> None:
        """Restrict the sweep to the sectors of ``sectors_list.restart``
        widened by +-ed_sectors_shift in each quantum number."""
        if not self.cfg.ed_sectors or not os.path.exists(path):
            return
        ns = self.cfg.ns
        shift = self.cfg.ed_sectors_shift
        mask = np.zeros(self.cfg.nsectors, dtype=bool)
        with open(path) as fh:
            for line in fh:
                toks = line.split()
                if len(toks) < 2:
                    continue
                nup0, ndw0 = int(toks[0]), int(toks[1])
                for du in range(-shift, shift + 1):
                    for dd in range(-shift, shift + 1):
                        nup, ndw = nup0 + du, ndw0 + dd
                        if 0 <= nup <= ns and 0 <= ndw <= ns:
                            mask[fock.get_sector(nup, ndw, ns) - 1] = True
        if mask.any():
            self.sectors_mask = mask

    def save_sectors_restart(self, path: str) -> None:
        """T=0 post-diag sector list (ED_DIAG.f90:384-392)."""
        ns = self.cfg.ns
        with open(path, "w") as fh:
            for st in self.state_list:
                nup, ndw = fock.get_quantum_numbers(st.isector, ns)
                fh.write(f" {nup} {ndw}\n")

    def save_histogram(self, path: str) -> None:
        """Finite-T sector histogram (ED_DIAG.f90:396-412)."""
        counts = np.zeros(self.cfg.nsectors, dtype=np.int64)
        for st in self.state_list:
            counts[st.isector - 1] += 1
        with open(path, "a") as fh:
            for i in np.nonzero(counts)[0]:
                fh.write(f"{i + 1:6d} {counts[i]:6d}\n")
            fh.write("\n")


SectorBuilder = Callable[[int, int], sector_ham.SectorOperator]


def _kit(op: sector_ham.SectorOperator, dtype, device):
    """(apply_fn, dev, is_real, dim_p, embed, extract): the real kit of a
    real ``op``, else the complex pair kit; NotImplementedError for
    factors beyond the dense-factor limit."""
    if max(op.dim_up, op.dim_dw) > split.DENSE_FACTOR_MAX:
        raise NotImplementedError(_LARGE_TODO)
    kit = split.build_real_padded(op, dtype=dtype, device=device)
    if kit is not None:
        return (split.apply_real_flat, kit[0], True) + tuple(kit[1:])
    dev, _, dim_p, embed, extract = split.build_pair_padded(
        op, dtype=dtype, device=device)
    return split.apply_pair_flat, dev, False, dim_p, embed, extract


def _solve_batched(cfg: EDConfig, members, key, ncv_g, device, verbose,
                   results: dict) -> None:
    """One batched solve over same-bucket sectors ``members``
    [(isector, op, dim, neigen, nblock, nitermax)] of one kind (``key``'s
    last entry: real or complex), chunked so that the Krylov bases and
    operator stacks stay within a quarter of the device memory."""
    ddp, dup, nterms, is_real = key
    dim_p = ddp * dup
    planes = 1 if is_real else 2        # complex vectors and factors
    op_bytes = (dim_p + planes * (ddp * ddp + dup * dup)
                + nterms * (ddp * ddp + dup * dup)) * 8
    member_bytes = (ncv_g + 1) * dim_p * 8 * planes + op_bytes
    bmax = max(2, int(budget_bytes(device, 0.25) / member_bytes))
    if is_real:
        stack, apply_b = split.stack_real_ops, split.apply_real_flat_batched
        eigh, mixed = (lanczos.lanczos_eigh_real_batched,
                       lanczos.lanczos_eigh_mixed_real_batched)
    else:
        stack, apply_b = split.stack_pair_ops, split.apply_pair_flat_batched
        eigh, mixed = (lanczos.lanczos_eigh_split_batched,
                       lanczos.lanczos_eigh_mixed_split_batched)
    for lo in range(0, len(members), bmax):
        chunk = members[lo:lo + bmax]
        if len(chunk) < 2:
            break
        t0 = time.time()
        neigen_g = max(m[3] for m in chunk)
        maxiter_g = max(m[5] for m in chunk) * ncv_g
        rng = np.random.default_rng(8527)
        # start vectors drawn member by member, as the JAX package draws
        # them (a complex member takes its real then its imaginary part)
        v0 = np.stack([split.embed_real(
            rng.normal(size=m[2]) if is_real
            else rng.normal(size=m[2]) + 1j * rng.normal(size=m[2]),
            m[1].dim_dw, m[1].dim_up, ddp, dup) for m in chunk])
        ops = [m[1] for m in chunk]
        if cfg.ed_precision == "mixed":
            def fb64(i, v0_row, _ops=ops):
                # full-f64 polish at the caller's tolerance
                apply1, dev_i = _kit(_ops[i], torch.float64, device)[:2]
                solve1 = (lanczos.lanczos_eigh_real if is_real
                          else lanczos.lanczos_eigh_split)
                return solve1(
                    apply1, dim_p, neigen=neigen_g, ncv=ncv_g,
                    maxiter=maxiter_g,
                    tol=max(cfg.lanc_tolerance, lanczos._f64_dot_floor()),
                    v0=v0_row, op=dev_i)

            res_list = mixed(
                apply_b, apply_b, len(chunk), dim_p, neigen=neigen_g,
                ncv=ncv_g, maxiter=maxiter_g, tol=cfg.lanc_tolerance, v0=v0,
                op32=stack(ops, (ddp, dup), dtype=torch.float32,
                           device=device),
                op64=lambda _o=ops: stack(_o, (ddp, dup), device=device),
                fallback64=fb64, vec_rtol=cfg.ed_mixed_vec_tol)
        else:
            res_list = eigh(
                apply_b, len(chunk), dim_p, neigen=neigen_g, ncv=ncv_g,
                maxiter=maxiter_g, tol=cfg.lanc_tolerance, v0=v0,
                op=stack(ops, (ddp, dup), device=device))
        for m, res in zip(chunk, res_list):
            isector, op, dim, neigen = m[0], m[1], m[2], m[3]
            if not res.converged:
                warnings.warn(
                    f"sector {isector}: batched eigensolve halted above "
                    f"the certification floor; retained eigenpairs may be "
                    f"degraded", RuntimeWarning)
            vecs = split.extract_real(np.asarray(res.eigenvectors)[:neigen],
                                      op.dim_dw, op.dim_up, ddp, dup)
            results[isector] = (np.asarray(res.eigenvalues)[:neigen], vecs)
        verbose(f"batched {len(chunk)} {'real' if is_real else 'complex'} "
                f"sectors (bucket {ddp}x{dup}, ncv={ncv_g}) "
                f"[{time.time() - t0:6.2f}s]")


def _solve_serial(cfg: EDConfig, op, dim, neigen, nblock, nitermax,
                  device):
    rng = np.random.default_rng(8527)
    apply1, dev, is_real, dim_p, embed, extract = _kit(op, torch.float64,
                                                       device)
    if is_real:
        v0 = embed(rng.normal(size=dim))
        solve1, mixed = lanczos.lanczos_eigh_real, \
            lanczos.lanczos_eigh_mixed_real
    else:
        v0 = embed(rng.normal(size=dim) + 1j * rng.normal(size=dim))
        solve1, mixed = lanczos.lanczos_eigh_split, lanczos.lanczos_eigh_mixed
    if cfg.ed_precision == "mixed":
        dev32 = _kit(op, torch.float32, device)[1]
        res = mixed(apply1, apply1, dim_p, neigen=neigen, ncv=nblock,
                    maxiter=nitermax * nblock, tol=cfg.lanc_tolerance,
                    v0=v0, op32=dev32, op64=dev,
                    vec_rtol=cfg.ed_mixed_vec_tol)
    else:
        res = solve1(apply1, dim_p, neigen=neigen, ncv=nblock,
                     maxiter=nitermax * nblock, tol=cfg.lanc_tolerance,
                     v0=v0, op=dev)
    return lanczos.EighResult(res.eigenvalues, extract(res.eigenvectors),
                              res.iterations, res.converged)


def diagonalize_impurity(state: DiagState, build: SectorBuilder,
                         device: torch.device,
                         log: Optional[Callable[[str], None]] = None
                         ) -> None:
    """The sector sweep (ed_diag_d, ED_DIAG.f90:53-260) + post-processing
    (ed_post_diag, ED_DIAG.f90:337-471)."""
    cfg = state.cfg
    ns = cfg.ns
    finite_t = cfg.finite_temp
    verbose = log if log is not None else (lambda s: None)

    state.state_list.free()
    oldzero = [1000.0]
    state.load_sectors_restart(os.path.join(
        cfg.work_dir, "sectors_list" + cfg.ed_file_suffix + ".restart"))
    eig_log_path = os.path.join(
        cfg.work_dir, "eigenvalues_list" + cfg.ed_file_suffix + ".ed")
    eig_log = []

    def sector_plan(isector):
        nup, ndw = fock.get_quantum_numbers(isector, ns)
        dim = fock.get_sector_dim(isector, ns)
        if cfg.lanc_method == "lanczos":
            neigen, nblock = 1, min(dim, 32)
        else:
            neigen = min(dim, int(state.neigen_sector[isector - 1]))
            nblock = min(dim, cfg.lanc_ncv_factor
                         * max(neigen, cfg.lanc_nstates_sector)
                         + cfg.lanc_ncv_add)
        nitermax = min(dim, cfg.lanc_niter)
        lanc_solve = (neigen != dim) and (dim > cfg.lanc_dim_threshold)
        return nup, ndw, dim, neigen, nblock, nitermax, lanc_solve

    active = [i for i in fock.all_sectors(ns)
              if state.sectors_mask[i - 1] and state.twin_mask[i - 1]]

    def retain(eig_values, eig_basis, isector, tflag):
        """Spectrum retention (finite-T capacity / T=0 degeneracy window,
        ED_DIAG.f90:229-245)."""
        if finite_t:
            for i in range(len(eig_values)):
                state.state_list.add(float(eig_values[i]), eig_basis[i],
                                     isector, ns, twin=tflag,
                                     size=state.lanc_nstates_total)
            return
        for i in range(len(eig_values)):
            enemin = float(eig_values[i])
            if enemin < oldzero[0] - 10.0 * cfg.gs_threshold:
                oldzero[0] = enemin
                state.state_list.free()
                state.state_list.insert(enemin, eig_basis[i], isector, ns,
                                        twin=tflag)
            elif abs(enemin - oldzero[0]) <= cfg.gs_threshold:
                oldzero[0] = min(oldzero[0], enemin)
                state.state_list.insert(enemin, eig_basis[i], isector, ns,
                                        twin=tflag)

    # --- sector-parallel batched dispatch: same-bucket Lanczos sectors of
    # one kind (real or complex) run through one batched thick-restart
    # stream ---
    batched_results = {}
    groups = {}
    for isector in active:
        nup, ndw, dim, neigen, nblock, nitermax, lanc_solve = \
            sector_plan(isector)
        if not lanc_solve:
            continue
        op = build(nup, ndw)
        if max(op.dim_up, op.dim_dw) > split.DENSE_FACTOR_MAX:
            raise NotImplementedError(_LARGE_TODO)
        key = (split._bucket(op.dim_dw), split._bucket(op.dim_up),
               len(op.nd_terms), split.op_is_real(op))
        groups.setdefault(key, []).append(
            (isector, op, dim, neigen, nblock, nitermax))
    for key, members in groups.items():
        if len(members) < 2:
            continue
        ncv_g = max(m[4] for m in members)
        members = [m for m in members if m[2] > ncv_g]
        if len(members) >= 2:
            _solve_batched(cfg, members, key, ncv_g, device, verbose,
                           batched_results)

    for isector in active:
        nup, ndw, dim, neigen, nblock, nitermax, lanc_solve = \
            sector_plan(isector)
        tflag = cfg.ed_twin and (nup != ndw)

        t0 = time.time()
        if isector in batched_results:
            eig_values, eig_basis = batched_results.pop(isector)
            verbose(f"sector {isector:5d} (nup={nup:2d},ndw={ndw:2d}) "
                    f"dim={dim:8d} lanc(batched) "
                    f"E0={eig_values[0]: .10f}")
            eig_log.append((isector, nup, ndw, eig_values[:neigen]))
            retain(eig_values, eig_basis, isector, tflag)
            continue
        op = build(nup, ndw)
        if lanc_solve:
            res = _solve_serial(cfg, op, dim, neigen, nblock, nitermax,
                                device)
            # escalate-on-stall: retry with grown ncv/maxiter (bounded by
            # the device memory budget) before anything is retained
            esc = 0
            while not res.converged and esc < 2 and nblock < dim:
                grown = int(min(dim, max(nblock * 2, nblock + 4)))
                if (grown + 1) * dim * 16 > budget_bytes(device, 0.25):
                    break
                verbose(f"sector {isector}: unconverged at ncv={nblock}; "
                        f"escalating to ncv={grown}, maxiter x2")
                nblock, nitermax = grown, nitermax * 2
                res = _solve_serial(cfg, op, dim, neigen, nblock, nitermax,
                                    device)
                esc += 1
            if not res.converged:
                warnings.warn(
                    f"sector {isector}: eigensolve did not reach tolerance "
                    f"after ncv escalation to {nblock}; retained eigenpairs "
                    f"may be degraded", RuntimeWarning)
            eig_values = np.asarray(res.eigenvalues)
            eig_basis = np.asarray(res.eigenvectors)
        else:
            w, vecs = lanczos.dense_eigh(op.to_dense())
            eig_values = w[:neigen]
            eig_basis = vecs[:neigen]
        verbose(f"sector {isector:5d} (nup={nup:2d},ndw={ndw:2d}) dim={dim:8d}"
                f" {'lanc' if lanc_solve else 'eigh'}"
                f" E0={eig_values[0]: .10f} [{time.time()-t0:6.2f}s]")
        eig_log.append((isector, nup, ndw, eig_values[:neigen]))
        retain(eig_values, eig_basis, isector, tflag)

    # eigenvalues_list.ed (ED_DIAG.f90:247-252)
    try:
        with open(eig_log_path, "a") as fh:
            for isector, nup, ndw, vals in eig_log:
                row = " ".join(f"{v:25.15f}" for v in vals)
                fh.write(f"{isector:6d} {nup:3d} {ndw:3d} {row}\n")
    except OSError:
        pass

    _post_diag(state, verbose)

    if cfg.finite_temp:
        state.save_histogram(os.path.join(
            cfg.work_dir, "histogram_states" + cfg.ed_file_suffix + ".ed"))
    else:
        state.save_sectors_restart(os.path.join(
            cfg.work_dir, "sectors_list" + cfg.ed_file_suffix + ".restart"))


def _post_diag(state: DiagState, verbose) -> None:
    """Partition function + finite-T spectrum management
    (ed_post_diag, ED_DIAG.f90:337-471)."""
    cfg = state.cfg
    sl = state.state_list
    egs = sl.emin

    if cfg.finite_temp:
        state.zeta_function = float(sum(
            np.exp(-cfg.beta * (s.energy - egs)) for s in sl))
    else:
        state.zeta_function = float(sl.size)

    if not cfg.finite_temp:
        return

    # adapt neigen_sector (ED_DIAG.f90:420-440)
    sectors = [s.isector for s in sl]
    for i in range(cfg.nsectors):
        cnt = sectors.count(i + 1)
        if cnt > 0:
            state.neigen_sector[i] += 1
        else:
            state.neigen_sector[i] -= 1
        if state.neigen_sector[i] > cnt:
            state.neigen_sector[i] = cnt + 1
        if state.neigen_sector[i] <= 0:
            state.neigen_sector[i] = 1

    # Boltzmann cutoff management (ED_DIAG.f90:444-470)
    ec = sl.emax
    if np.exp(-cfg.beta * (ec - egs)) > cfg.cutoff:
        state.lanc_nstates_total += cfg.lanc_nstates_step
        verbose(f"increasing lanc_nstates_total -> {state.lanc_nstates_total}")
    else:
        while sl.size > 1 and \
                np.exp(-cfg.beta * (sl.emax - egs)) <= cfg.cutoff:
            sl.pop()
        state.lanc_nstates_total = max(sl.size, cfg.lanc_nstates_step) \
            + cfg.lanc_nstates_step
