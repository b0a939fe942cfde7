"""Observables: thermal averages, energies, density matrices.

Port of the host path of the JAX package's ``observables.py`` (itself a
re-implementation of the reference's ED_OBSERVABLES.f90).  The retained
eigenvectors of the dense-factor kit live on the host, so these are host
numpy reductions, as in the JAX package.  All
quantities are **vectorised reductions** over the sector basis instead of the
reference's per-Fock-state loops (ED_OBSERVABLES.f90:146-236):

* occupations are bit tables ``n_up[DimUp, Nimp]`` / ``n_dw[DimDw, Nimp]``
  already produced by the Hamiltonian setup;
* cross-spin correlators factorise through the probability matrix
  ``P[DimDw, DimUp] = peso*|psi|^2`` as matmuls ``n_dw^T P n_up``;
* the cluster density matrix ``rho_IMP = Tr_BATH |psi><psi|`` replaces the
  reference's quadruple loop + sparse-map intersection search
  (ED_OBSERVABLES.f90:514-575) with a bath-configuration grouping and
  batched outer-product contractions.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .config import EDConfig
from .diag import DiagState
from .utils import fock


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _state_weights(cfg: EDConfig, state: DiagState):
    """(state, peso) pairs: Boltzmann weights (lanc_observables,
    ED_OBSERVABLES.f90:134-136)."""
    egs = state.state_list.emin
    for st in state.state_list:
        peso = 1.0
        if cfg.finite_temp:
            peso = float(np.exp(-cfg.beta * (st.energy - egs)))
        yield st, peso / state.zeta_function


def _prob_and_occs(cfg: EDConfig, st, ns: int):
    nup, ndw = fock.get_quantum_numbers(st.isector, ns)
    states_up = fock.sector_states(ns, nup)
    states_dw = fock.sector_states(ns, ndw)
    v2d = np.asarray(st.get_vector(ns)).reshape(len(states_dw),
                                                len(states_up))
    prob = np.abs(v2d) ** 2
    n_up = fock.number_op(states_up, np.arange(cfg.nimp))
    n_dw = fock.number_op(states_dw, np.arange(cfg.nimp))
    return v2d, prob, n_up, n_dw, states_up, states_dw


# ---------------------------------------------------------------------------
# local observables (lanc_observables, ED_OBSERVABLES.f90:94-236)
# ---------------------------------------------------------------------------

@dataclass
class Observables:
    dens: np.ndarray       # [Nlat, Norb]
    dens_up: np.ndarray
    dens_dw: np.ndarray
    docc: np.ndarray
    magz: np.ndarray
    sz2: np.ndarray        # [Nlat, Nlat, Norb, Norb]
    n2: np.ndarray
    s2tot: np.ndarray      # [Nlat]


def observables_impurity(cfg: EDConfig, state: DiagState) -> Observables:
    nlat, norb, nimp, ns = cfg.nlat, cfg.norb, cfg.nimp, cfg.ns
    dens_up = np.zeros(nimp)
    dens_dw = np.zeros(nimp)
    docc = np.zeros(nimp)
    nn = np.zeros((nimp, nimp))      # <n_a n_b> total densities
    szsz = np.zeros((nimp, nimp))    # <Sz_a Sz_b>
    s2tot = np.zeros(nlat)

    site = np.repeat(np.arange(nlat), norb)
    for st, peso in _state_weights(cfg, state):
        _, prob, n_up, n_dw, _, _ = _prob_and_occs(cfg, st, ns)
        pu = prob.sum(axis=0) @ n_up          # [Nimp] sum_i P n_up
        pd = prob.sum(axis=1) @ n_dw
        dens_up += peso * pu
        dens_dw += peso * pd
        # <n_up_a n_dw_b> cross matrix via matmul
        cross = n_dw.T @ prob @ n_up          # [b(dw), a(up)] -> [Nimp,Nimp]
        docc += peso * np.diag(cross)
        # same-spin pair averages <n_s_a n_s_b>
        uu = n_up.T @ np.diag(prob.sum(axis=0)) @ n_up
        dd = n_dw.T @ np.diag(prob.sum(axis=1)) @ n_dw
        nn += peso * (uu + dd + cross + cross.T)
        szsz += peso * 0.25 * (uu + dd - cross - cross.T)
        # S^2_tot per site: (sum_orb Sz)^2
        sz_up = np.zeros((prob.shape[1], nlat))
        sz_dw = np.zeros((prob.shape[0], nlat))
        for a in range(nimp):
            sz_up[:, site[a]] += 0.5 * n_up[:, a]
            sz_dw[:, site[a]] -= 0.5 * n_dw[:, a]
        # <(Su + Sd)^2> = <Su^2> + 2<Su><Sd>... need joint: vectorised:
        # (sz_up[iup] + sz_dw[idw])^2 weighted by prob
        for il in range(nlat):
            val = (sz_up[None, :, il] + sz_dw[:, None, il]) ** 2
            s2tot[il] += peso * float((prob * val).sum())

    def to_latorb(x):
        return x.reshape(nlat, norb)

    return Observables(
        dens=to_latorb(dens_up + dens_dw),
        dens_up=to_latorb(dens_up), dens_dw=to_latorb(dens_dw),
        docc=to_latorb(docc),
        magz=to_latorb(dens_up - dens_dw),
        sz2=szsz.reshape(nlat, norb, nlat, norb).transpose(0, 2, 1, 3),
        n2=nn.reshape(nlat, norb, nlat, norb).transpose(0, 2, 1, 3),
        s2tot=s2tot)


# ---------------------------------------------------------------------------
# local energy (lanc_local_energy, ED_OBSERVABLES.f90:246-452)
# ---------------------------------------------------------------------------

@dataclass
class EnergyTerms:
    eknot: float = 0.0       # <H_imp> one-body
    epot: float = 0.0        # <H_int> including Hartree
    ehartree: float = 0.0
    dust: float = 0.0        # <n_up n_dw> inter-orbital
    dund: float = 0.0        # <n_s n_s> inter-orbital parallel
    dse: float = 0.0
    dph: float = 0.0


def local_energy_impurity(cfg: EDConfig, imp_hloc: np.ndarray,
                          state: DiagState) -> EnergyTerms:
    nlat, norb, nimp, ns = cfg.nlat, cfg.norb, cfg.nimp, cfg.ns
    uloc = cfg.uloc_arr
    ust, jh = cfg.ust, cfg.jh
    out = EnergyTerms()
    s_dw = cfg.nspin - 1

    # impurity one-body hop terms per spin (diag excluded)
    def hop_terms(s):
        terms = []
        for il in range(nlat):
            for jl in range(nlat):
                for io in range(norb):
                    for jo in range(norb):
                        a = fock.imp_level(il, io, norb)
                        b = fock.imp_level(jl, jo, norb)
                        if a == b:
                            continue
                        amp = imp_hloc[il, jl, s, s, io, jo]
                        if amp != 0:
                            terms.append((a, b, complex(amp)))
        return terms

    for st, peso in _state_weights(cfg, state):
        v2d, prob, n_up, n_dw, states_up, states_dw = \
            _prob_and_occs(cfg, st, ns)
        pu = prob.sum(axis=0) @ n_up
        pd = prob.sum(axis=1) @ n_dw
        cross = n_dw.T @ prob @ n_up
        uu = n_up.T @ np.diag(prob.sum(axis=0)) @ n_up
        dd = n_dw.T @ np.diag(prob.sum(axis=1)) @ n_dw

        # one-body diagonal (ED_OBSERVABLES.f90:303-310)
        for il in range(nlat):
            for io in range(norb):
                a = fock.imp_level(il, io, norb)
                out.eknot += peso * (
                    imp_hloc[il, il, 0, 0, io, io].real * pu[a]
                    + imp_hloc[il, il, s_dw, s_dw, io, io].real * pd[a])
        # one-body off-diagonal: <psi| sum amp c^+_a c_b |psi> per spin
        # (ED_OBSERVABLES.f90:311-348)
        for s, (states, apply_axis) in enumerate(
                ((states_up, 1), (states_dw, 0))):
            for a, b, amp in hop_terms(0 if s == 0 else s_dw):
                rows, cols, signs = fock.hop_entries(states, a, b)
                if apply_axis == 1:   # up factor: columns of v2d
                    contrib = (v2d[:, cols] * signs *
                               np.conj(v2d[:, rows])).sum()
                else:                 # dw factor: rows of v2d
                    contrib = (v2d[cols, :] * signs[:, None] *
                               np.conj(v2d[rows, :])).sum()
                out.eknot += peso * float((amp * contrib).real)

        # interactions (ED_OBSERVABLES.f90:352-395)
        dud = np.diag(cross)                       # <n_up_a n_dw_a>
        for il in range(nlat):
            for io in range(norb):
                a = fock.imp_level(il, io, norb)
                out.epot += peso * uloc[io] * dud[a]
            for io in range(norb):
                for jo in range(io + 1, norb):
                    a = fock.imp_level(il, io, norb)
                    b = fock.imp_level(il, jo, norb)
                    pair_ud = cross[b, a] + cross[a, b]
                    pair_ss = uu[a, b] + dd[a, b]
                    out.epot += peso * (ust * pair_ud
                                        + (ust - jh) * pair_ss)
                    out.dust += peso * pair_ud
                    out.dund += peso * pair_ss
        # Hartree (ED_OBSERVABLES.f90:398-420; uloc index bug fixed: the
        # reference indexes uloc by the imp level, we use the orbital)
        if cfg.hfmode:
            for il in range(nlat):
                for io in range(norb):
                    a = fock.imp_level(il, io, norb)
                    out.ehartree += peso * (-0.5 * uloc[io]
                                            * (pu[a] + pd[a])
                                            + 0.25 * uloc[io])
                for io in range(norb):
                    for jo in range(io + 1, norb):
                        a = fock.imp_level(il, io, norb)
                        b = fock.imp_level(il, jo, norb)
                        ntot = pu[a] + pd[a] + pu[b] + pd[b]
                        out.ehartree += peso * (
                            -0.5 * ust * ntot + 0.25 * ust
                            - 0.5 * (ust - jh) * ntot + 0.25 * (ust - jh))
    out.epot += out.ehartree
    return out


# ---------------------------------------------------------------------------
# cluster + single-particle density matrices
# (density_matrix_impurity, ED_OBSERVABLES.f90:465-686)
# ---------------------------------------------------------------------------

def cluster_density_matrix(cfg: EDConfig, state: DiagState) -> np.ndarray:
    """rho_IMP = Tr_BATH |psi><psi| of dim [4^Nimp, 4^Nimp].

    Impurity composite index io = IimpUp + 2^Nimp * IimpDw (reference
    convention, ED_OBSERVABLES.f90:559-561).  Vectorised: sector states are
    grouped by their bath configuration; within a (bath_up, bath_dw) block
    the partial trace is an outer product accumulated per impurity label.
    """
    nimp, ns = cfg.nimp, cfg.ns
    dim_imp = 1 << nimp
    rho = np.zeros((dim_imp * dim_imp, dim_imp * dim_imp), np.complex128)
    mask = (1 << nimp) - 1

    for st, peso in _state_weights(cfg, state):
        nup, ndw = fock.get_quantum_numbers(st.isector, ns)
        states_up = fock.sector_states(ns, nup)
        states_dw = fock.sector_states(ns, ndw)
        vec = st.get_vector(ns)
        v2d = np.asarray(vec).reshape(len(states_dw),
                                      len(states_up))
        imp_up = (states_up & mask).astype(np.int64)
        bath_up = (states_up >> nimp).astype(np.int64)
        imp_dw = (states_dw & mask).astype(np.int64)
        bath_dw = (states_dw >> nimp).astype(np.int64)
        # group up/dw states by bath configuration
        ub_vals, ub_inv = np.unique(bath_up, return_inverse=True)
        db_vals, db_inv = np.unique(bath_dw, return_inverse=True)
        n_ub, n_db = len(ub_vals), len(db_vals)
        # scatter into X[imp_dw, db_group, imp_up, ub_group] block-sparse;
        # chunk over ub groups to bound memory
        for g in range(n_ub):
            cols = np.nonzero(ub_inv == g)[0]
            iu = imp_up[cols]
            # X[id_label, db, iu_label]
            x = np.zeros((dim_imp, n_db, dim_imp), np.complex128)
            x[imp_dw[:, None].repeat(len(cols), 1),
              db_inv[:, None].repeat(len(cols), 1),
              iu[None, :].repeat(len(imp_dw), 0)] = v2d[:, cols]
            # rho[(iu,id),(ju,jd)] += sum_db x[id,db,iu] conj(x[jd,db,ju])
            contrib = np.einsum("dbi,ebj->diej", x, x.conj())
            # contrib axes [id, iu, jd, ju]: composite label
            # io = IimpUp + 2^Nimp * IimpDw on BOTH sides (reference
            # convention ED_OBSERVABLES.f90:559-561) -> C-order reshape of
            # [id, iu] rows and [jd, ju] cols
            contrib = contrib.reshape(dim_imp * dim_imp,
                                      dim_imp * dim_imp)
            rho += peso * contrib
    return rho


def single_particle_density_matrix(cfg: EDConfig,
                                   state: DiagState) -> np.ndarray:
    """<c^+_a c_b> over impurity levels: [Nlat,Nlat,Nspin,Nspin,Norb,Norb]
    (ED_OBSERVABLES.f90:594-686; spin-diagonal)."""
    nlat, norb, nimp, ns = cfg.nlat, cfg.norb, cfg.nimp, cfg.ns
    nspin = cfg.nspin
    out = np.zeros((nlat, nlat, nspin, nspin, norb, norb), np.complex128)

    for st, peso in _state_weights(cfg, state):
        v2d, prob, n_up, n_dw, states_up, states_dw = \
            _prob_and_occs(cfg, st, ns)
        for s in range(nspin):
            states = states_up if s == 0 else states_dw
            for a in range(nimp):
                for b in range(nimp):
                    ila, ioa = divmod(a, norb)
                    ilb, iob = divmod(b, norb)
                    if a == b:
                        occ = n_up[:, a] if s == 0 else n_dw[:, a]
                        p = prob.sum(axis=0) if s == 0 else prob.sum(axis=1)
                        val = float(p @ occ)
                    else:
                        rows, cols, signs = fock.hop_entries(states, a, b)
                        if s == 0:
                            val = (np.conj(v2d[:, rows]) * signs
                                   * v2d[:, cols]).sum()
                        else:
                            val = (np.conj(v2d[rows, :]) * signs[:, None]
                                   * v2d[cols, :]).sum()
                    out[ila, ilb, s, s, ioa, iob] += peso * val
    return out
