"""Sector-sweep diagonalization driver.

Port of the JAX package's ``diag.py`` (dense-factor path): loop over all
(N_up, N_dw) Fock sectors, solve each with the dense path (small dims) or
the thick-restart Lanczos eigensolver, and keep the retained eigenstates in
the capacity-constrained :class:`~.eigenspace.StateList`.  Real sectors
take the real kit, complex ones the complex pair kit (``kit.py`` chooses
each sector's kit).  Same-bucket sectors
of one kind are solved as one batch (one device stream, shared restart
schedule); the rest are solved one by one.  ``ed_precision="mixed"`` runs
the f32 (complex64) Krylov stage on the fused CUDA H·v and refines in f64
(complex128).

Spin factors beyond the dense-factor limit (Ns >= 16) take the
block-sparse large kits of ``ops/large.py`` (the JAX package's
diag.py:561-675, single-chip branches): each such sector is solved on its
own, its eigenvectors stay on the card.  A mixed solve runs a bf16
coarse stage, the f32 (complex64) stage and the f64 (complex128) refine,
all on the tile kit, for real and complex sectors alike (the JAX
package's two-kit f64 routing through ``hier_dev`` existed for a 16 GB
chip and is not ported).

With a mesh installed (``parallel.multichip.set_solver_mesh``), the
routing is the JAX package's (diag.py:187-500): same-bucket batches are
padded to a multiple of the "sector" axis (pad slots filled with
compatible leftover sectors, else duplicates) and split over its ranks,
which then gather every eigenpair; a sector of dim >= 64·lanc_dim_threshold
is solved on the dw-sharded block-sparse kits of
``parallel/sharded_large.py`` whenever the mesh has a "dw" axis.  Every
rank runs the whole sweep (SPMD) and ends with the whole state list.
"""
from __future__ import annotations

import contextlib
import os
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from . import kit
from .config import EDConfig
from .device import budget_bytes
from .eigenspace import StateList
from .ops import lanczos, sector_ham, split
from .parallel import multichip
from .utils import fock
from .utils.timer import span, to_host


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


def _start(dim: int, real: bool, rng=None) -> np.ndarray:
    """The seeded start vector of a sector of ``dim``: ``rng`` (default
    ``default_rng(8527)``) draws its real part, then for a complex
    sector its imaginary part, as the JAX package draws them."""
    rng = np.random.default_rng(8527) if rng is None else rng
    return rng.normal(size=dim) if real else \
        rng.normal(size=dim) + 1j * rng.normal(size=dim)


def _eigensolve(cfg: EDConfig, op, device, neigen, ncv, maxiter, *,
                tol=None, mixed=None, shard_from=None, v0=None,
                start_span=None):
    """One sector on its kit (``kit.kit_for``; sharded from
    ``shard_from``).  ``mixed`` (default: ``ed_precision="mixed"``) runs
    the bf16 coarse stage where the kit has one, the f32 (complex64)
    Krylov stage, the f64 (complex128) refine on an operator built after
    it and the f64 re-solve (``lanczos.eigh_mixed``); else one f64
    solve, to ``tol`` (default ``lanc_tolerance``).  ``v0`` (the kit's
    rows) defaults to the seeded start vector, drawn inside
    ``start_span`` when given.  Returns (the result on the kit's rows,
    its eigenvectors on the device; the kit)."""
    if mixed is None:
        mixed = cfg.ed_precision == "mixed"
    k = kit.kit_for(op, torch.float32 if mixed else torch.float64, device,
                    shard_from=shard_from)
    if v0 is None:
        with span(start_span) if start_span else contextlib.nullcontext():
            v0 = k.embed(_start(op.dim, k.real))
    kw = dict(neigen=neigen, ncv=ncv, maxiter=maxiter, v0=v0,
              tol=cfg.lanc_tolerance if tol is None else tol,
              dtype=k.vectors, device_vectors=True)
    if not mixed:
        return lanczos.eigh(k.apply, k.dim_p, op=k.dev, **kw), k
    # the bf16 operator is passed, not held, so the solver frees it after
    # its stage
    return lanczos.eigh_mixed(
        k.apply, k.apply, k.dim_p, op32=k.dev,
        op64=lambda: kit.kit_for(op, torch.float64, device,
                                 shard_from=shard_from, reuse=k).dev,
        op16=k.coarse() if k.coarse else None,
        vec_rtol=cfg.ed_mixed_vec_tol, **kw), k


def _solve_batched(cfg: EDConfig, members, key, ncv_g, device, verbose,
                   results: dict, leftovers=(), mesh=None) -> None:
    """One batched solve over same-bucket sectors ``members``
    [(isector, op, dim, neigen, nblock, nitermax)] of one kind (``key``'s
    last entry: real or complex), chunked so that the Krylov bases and
    operator stacks stay within a quarter of the device memory.

    With a "sector" axis of size n > 1 on ``mesh``, each chunk is padded
    to a multiple of n (the JAX package's diag.py:262-283): pad slots take
    sectors of ``leftovers`` (a list, consumed) that embed in the bucket,
    are of the same kind and term count and exceed ncv, then duplicates;
    each rank solves its share and the eigenpairs are gathered over the
    axis."""
    ddp, dup, nterms, is_real = key
    dim_p = ddp * dup
    planes = 1 if is_real else 2        # complex vectors and factors
    op_bytes = (dim_p + planes * (ddp * ddp + dup * dup)
                + nterms * (ddp * ddp + dup * dup)) * 8
    member_bytes = (ncv_g + 1) * dim_p * 8 * planes + op_bytes
    bmax = max(2, int(budget_bytes(device, 0.25) / member_bytes))
    apply_b = kit.stacked_apply(is_real)
    dt32, dt64 = (torch.float32, torch.float64) if is_real \
        else (torch.complex64, torch.complex128)
    nsec = multichip.sector_axis_size(mesh)
    for lo in range(0, len(members), bmax):
        chunk = members[lo:lo + bmax]
        if len(chunk) < 2:
            break
        with span("diag.batch",
                  sectors=[(m[1].nup, m[1].ndw) for m in chunk],
                  bucket=(ddp, dup),
                  kind="real" if is_real else "complex") as sp:
            batch, fillers = list(chunk), []
            if nsec > 1 and len(batch) % nsec:
                padn = nsec - len(batch) % nsec
                for lv in list(leftovers):
                    if len(fillers) >= padn:
                        break
                    lop = lv[1]
                    if (lop.dim_dw <= ddp and lop.dim_up <= dup
                            and len(lop.nd_terms) == nterms
                            and split.op_is_real(lop) == is_real
                            and lv[2] > ncv_g):
                        fillers.append(lv)
                        leftovers.remove(lv)
                batch += fillers
                batch += [batch[j % len(batch)]
                          for j in range(padn - len(fillers))]
            solved = list(chunk) + fillers
            neigen_g = max(m[3] for m in solved)
            maxiter_g = max(m[5] for m in solved) * ncv_g
            # this rank's share of the batch (all of it without a sector
            # axis)
            mine = multichip.shard_batched_stack(range(len(batch)), mesh)
            ops = [batch[i][1] for i in mine]

            def stacked(dtype=torch.float64, _o=ops):
                with span("diag.batch.stack"):
                    return kit.stacked(_o, (ddp, dup), is_real, dtype,
                                       device)

            with span("diag.batch.stack"):
                rng = np.random.default_rng(8527)
                # start vectors drawn member by member, as the JAX package
                # draws them
                v0 = np.stack([split.embed_real(
                    _start(m[2], is_real, rng), m[1].dim_dw, m[1].dim_up,
                    ddp, dup) for m in batch])
                v0 = v0[mine.start:mine.stop]
            kw = dict(neigen=neigen_g, ncv=ncv_g, maxiter=maxiter_g,
                      tol=cfg.lanc_tolerance, v0=v0)
            if cfg.ed_precision == "mixed":
                def fb64(i, v0_row, _ops=ops):
                    # full-f64 polish at the caller's tolerance
                    with span("lanczos.f64_resolve",
                              sector=(_ops[i].nup, _ops[i].ndw)):
                        res = _eigensolve(
                            cfg, _ops[i], device, neigen_g, ncv_g,
                            maxiter_g, tol=max(cfg.lanc_tolerance,
                                               lanczos._f64_dot_floor()),
                            mixed=False, v0=v0_row)[0]
                        return res._replace(
                            eigenvectors=to_host(res.eigenvectors))
                # the f32 stack is passed, not held, so the solver frees
                # it after its stage
                res_list = lanczos.eigh_mixed_batched(
                    apply_b, apply_b, len(ops), dim_p, op32=stacked(
                        torch.float32), op64=stacked, fallback64=fb64,
                    vec_rtol=cfg.ed_mixed_vec_tol, dtype=dt32, **kw)
            else:
                res_list = lanczos.eigh_batched(
                    apply_b, len(ops), dim_p, op=stacked(), dtype=dt64,
                    **kw)
            gathered = multichip.gather_batched(
                [(np.asarray(r.eigenvalues), np.asarray(r.eigenvectors),
                  r.converged) for r in res_list], mesh)
            for m, (vals, vecs, converged) in zip(solved, gathered):
                isector, op, dim, neigen = m[0], m[1], m[2], m[3]
                if not converged:
                    warnings.warn(
                        f"sector {isector}: batched eigensolve halted above "
                        f"the certification floor; retained eigenpairs may "
                        f"be degraded", RuntimeWarning)
                vecs = split.extract_real(vecs[:neigen], op.dim_dw,
                                          op.dim_up, ddp, dup)
                results[isector] = (vals[:neigen], vecs)
            pad = f", {len(mine)} of {len(batch)} on this rank, " \
                f"{len(fillers)} pad slots filled" if nsec > 1 else ""
            verbose(f"batched {len(solved)} "
                    f"{'real' if is_real else 'complex'} "
                    f"sectors (bucket {ddp}x{dup}, ncv={ncv_g}{pad}) "
                    f"[{sp.seconds():6.2f}s]")


def _solve_large(cfg: EDConfig, op, dim, neigen, nblock, nitermax,
                 device):
    """One large sector on the one-card tile kit (the JAX package's
    diag.py:561-675, single chip); the eigenvectors stay on the device.
    A mixed solve runs the bf16 coarse stage, f32 (complex64) and the
    f64 (complex128) refine on an operator built after its Krylov
    stage."""
    res, k = _eigensolve(cfg, op, device, neigen, nblock,
                         nitermax * nblock, start_span="diag.large.start")
    return res._replace(eigenvectors=k.extract(res.eigenvectors))


def _solve_sharded(cfg: EDConfig, op, dim, neigen, nblock, nitermax,
                   device):
    """One sector on the dw-sharded tile kit (the JAX package's
    diag.py:432-500): each rank holds its rows of the Krylov basis; the
    start vector is drawn whole from the seed and sliced; mixed runs
    without a coarse stage, as the JAX mesh branch; the eigenvectors are
    gathered whole onto every rank (on the device for a large sector, on
    the host otherwise)."""
    res, k = _eigensolve(cfg, op, device, neigen, nblock,
                         nitermax * nblock,
                         shard_from=kit.eig_shard_from(cfg))
    vecs = k.extract(res.eigenvectors)
    return res._replace(eigenvectors=vecs if kit.is_large(op)
                        else to_host(vecs))


def _solve_serial(cfg: EDConfig, op, dim, neigen, nblock, nitermax,
                  device):
    """One sector on its own: on a "dw" mesh from dim
    64·lanc_dim_threshold on the sharded tile kit
    (:func:`_solve_sharded`), a large one on the one-card tile kit
    (:func:`_solve_large`), the others on their dense kit."""
    if kit.sharded(dim, kit.eig_shard_from(cfg)):
        return _solve_sharded(cfg, op, dim, neigen, nblock, nitermax,
                              device)
    if kit.is_large(op):
        return _solve_large(cfg, op, dim, neigen, nblock, nitermax, device)
    res, k = _eigensolve(cfg, op, device, neigen, nblock,
                         nitermax * nblock)
    return res._replace(eigenvectors=to_host(k.extract(res.eigenvectors)))


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
    # stream (split over the mesh's "sector" axis); large sectors, and on
    # a "dw" mesh every sector of dim >= 64·lanc_dim_threshold, are solved
    # one by one ---
    mesh = multichip.get_solver_mesh()
    batched_results = {}
    groups = {}
    for isector in active:
        nup, ndw, dim, neigen, nblock, nitermax, lanc_solve = \
            sector_plan(isector)
        if not lanc_solve:
            continue
        if kit.sharded(dim, kit.eig_shard_from(cfg)) or \
                kit.large_sector(ns, nup, ndw):
            continue                       # solved on its own below
        op = build(nup, ndw)
        key = (split._bucket(op.dim_dw), split._bucket(op.dim_up),
               len(op.nd_terms), split.op_is_real(op))
        groups.setdefault(key, []).append(
            (isector, op, dim, neigen, nblock, nitermax))
    # groups of one member, and members within ncv, are solved one by one
    # (or fill the pad slots of a batch split over the "sector" axis)
    batchable, leftovers = [], []
    for key, members in groups.items():
        if len(members) < 2:
            leftovers.extend(members)
            continue
        ncv_g = max(m[4] for m in members)
        leftovers.extend(m for m in members if m[2] <= ncv_g)
        members = [m for m in members if m[2] > ncv_g]
        if len(members) < 2:
            leftovers.extend(members)
            continue
        batchable.append((key, ncv_g, members))
    for key, ncv_g, members in batchable:
        _solve_batched(cfg, members, key, ncv_g, device, verbose,
                       batched_results, leftovers, mesh)

    for isector in active:
        nup, ndw, dim, neigen, nblock, nitermax, lanc_solve = \
            sector_plan(isector)
        tflag = cfg.ed_twin and (nup != ndw)

        if isector in batched_results:
            eig_values, eig_basis = batched_results.pop(isector)
            verbose(f"sector {isector:5d} (nup={nup:2d},ndw={ndw:2d}) "
                    f"dim={dim:8d} lanc(batched) "
                    f"E0={eig_values[0]: .10f}")
            eig_log.append((isector, nup, ndw, eig_values[:neigen]))
            with span("diag.retain"):
                retain(eig_values, eig_basis, isector, tflag)
            continue
        kind = ("diag.large" if kit.large_sector(ns, nup, ndw) else
                "diag.serial") if lanc_solve else "diag.dense"
        with span(kind, sector=(nup, ndw), dim=dim) as sp:
            op = build(nup, ndw)
            if lanc_solve:
                res = _solve_serial(cfg, op, dim, neigen, nblock, nitermax,
                                    device)
                # escalate-on-stall: retry with grown ncv/maxiter (bounded
                # by the device memory budget) before anything is retained
                esc = 0
                while not res.converged and esc < 2 and nblock < dim:
                    grown = int(min(dim, max(nblock * 2, nblock + 4)))
                    if (grown + 1) * dim * 16 > budget_bytes(device, 0.25):
                        break
                    verbose(f"sector {isector}: unconverged at ncv={nblock}; "
                            f"escalating to ncv={grown}, maxiter x2")
                    nblock, nitermax = grown, nitermax * 2
                    res = _solve_serial(cfg, op, dim, neigen, nblock,
                                        nitermax, device)
                    esc += 1
                if not res.converged:
                    warnings.warn(
                        f"sector {isector}: eigensolve did not reach "
                        f"tolerance after ncv escalation to {nblock}; "
                        f"retained eigenpairs may be degraded",
                        RuntimeWarning)
                eig_values = np.asarray(res.eigenvalues)
                eig_basis = res.eigenvectors          # large: on the device
                if not isinstance(eig_basis, torch.Tensor):
                    eig_basis = np.asarray(eig_basis)
            else:
                w, vecs = lanczos.dense_eigh(op.to_dense())
                eig_values = w[:neigen]
                eig_basis = vecs[:neigen]
        verbose(f"sector {isector:5d} (nup={nup:2d},ndw={ndw:2d}) dim={dim:8d}"
                f" {'lanc' if lanc_solve else 'eigh'}"
                f" E0={eig_values[0]: .10f} [{sp.seconds():6.2f}s]")
        eig_log.append((isector, nup, ndw, eig_values[:neigen]))
        with span("diag.retain"):
            retain(eig_values, eig_basis, isector, tflag)

    # eigenvalues_list.ed (ED_DIAG.f90:247-252)
    try:
        with open(eig_log_path, "a") as fh:
            for isector, nup, ndw, vals in eig_log:
                row = " ".join(f"{v:25.15f}" for v in vals)
                fh.write(f"{isector:6d} {nup:3d} {ndw:3d} {row}\n")
    except OSError:
        pass

    with span("diag.retain"):
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
