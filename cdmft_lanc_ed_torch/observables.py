"""Observables: thermal averages, energies, density matrices.

Port of the JAX package's ``observables.py`` (itself a re-implementation
of the reference's ED_OBSERVABLES.f90).  The retained eigenvectors of the
dense-factor kit live on the host, so those states take host numpy
reductions, as in the JAX package; a large-sector state stays on the card
and takes the device contractions of :mod:`.observables_device` (the JAX
package's observables.py:140-170, :255-329), of which only Nimp-sized
results reach the host.  All
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
import torch

from . import observables_device as obsdev
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


def _device_occs(cfg: EDConfig, st, ns: int):
    """(vec, shape2d, n_up, n_dw, states_up, states_dw) of a state kept
    on the card, or None for a host state."""
    vec = st.get_vector(ns)
    if not isinstance(vec, torch.Tensor):
        return None
    nup, ndw = fock.get_quantum_numbers(st.isector, ns)
    states_up = fock.sector_states(ns, nup)
    states_dw = fock.sector_states(ns, ndw)
    n_up = fock.number_op(states_up, np.arange(cfg.nimp))
    n_dw = fock.number_op(states_dw, np.arange(cfg.nimp))
    return (vec, (len(states_dw), len(states_up)), n_up, n_dw, states_up,
            states_dw)


def _device_reductions(cfg: EDConfig, dstate, with_sz: bool):
    """obsdev.density_reductions of a device state; the S_z tables are
    zeros unless ``with_sz``."""
    vec, shape2d, n_up, n_dw, _, _ = dstate
    site = np.repeat(np.arange(cfg.nlat), cfg.norb)
    sz_up = np.zeros((shape2d[1], cfg.nlat))
    sz_dw = np.zeros((shape2d[0], cfg.nlat))
    if with_sz:
        for a in range(cfg.nimp):
            sz_up[:, site[a]] += 0.5 * n_up[:, a]
            sz_dw[:, site[a]] -= 0.5 * n_dw[:, a]
    return obsdev.density_reductions(vec.reshape(shape2d), n_up, n_dw,
                                     sz_up, sz_dw)


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
        dstate = _device_occs(cfg, st, ns)
        if dstate is not None:
            pu, pd, cross, uu, dd, s2 = _device_reductions(cfg, dstate,
                                                           True)
            dens_up += peso * pu
            dens_dw += peso * pd
            docc += peso * np.diag(cross)
            nn += peso * (uu + dd + cross + cross.T)
            szsz += peso * 0.25 * (uu + dd - cross - cross.T)
            s2tot += peso * s2
            continue
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
        dstate = _device_occs(cfg, st, ns)
        if dstate is not None:
            # densities from the device reductions, hop terms (below)
            # from device index-gather contractions
            vec, shape2d, _, _, states_up, states_dw = dstate
            pu, pd, cross, uu, dd, _ = _device_reductions(cfg, dstate,
                                                          False)
        else:
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
            terms = hop_terms(0 if s == 0 else s_dw)
            if dstate is not None:
                if terms:
                    vals = obsdev.hop_sums_device(vec, shape2d, terms,
                                                  states, apply_axis)
                    out.eknot += peso * float(np.sum(vals).real)
                continue
            for a, b, amp in terms:
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
        if isinstance(vec, torch.Tensor):
            # device state: the bath trace on the card
            rho += peso * obsdev.cluster_dm_device(
                vec, (len(states_dw), len(states_up)), nimp, states_up,
                states_dw)
            continue
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


def von_neumann_entropy(rho: np.ndarray) -> float:
    """S = -Tr rho ln rho of a (reduced) density matrix."""
    w = np.linalg.eigvalsh(np.asarray(rho))
    w = w[w > 1e-14]
    return float(-(w * np.log(w)).sum())


def _sites_mask(cfg: EDConfig, sites) -> np.ndarray:
    mask = np.zeros((cfg.nlat, cfg.norb), bool)
    for s in np.atleast_1d(sites):
        mask[int(s), :] = True
    return mask


def site_entanglement_entropy(cfg: EDConfig, cdm: np.ndarray,
                              sites) -> float:
    """Entanglement entropy of the sub-cluster RDM traced down to
    ``sites`` (list of cluster-site indices) from the full cluster DM.

    This is the Walsh et al. PRL 122, 067203 (2019) local-entropy
    observable: s1 = -Tr rho_1 ln rho_1 with rho_1 the single-site RDM
    (their Eq. 2; the reference reproduces their 2x2-cluster T->0
    values, the reference's README.md:51).  The partial trace reuses the
    fermionic-sign reduced-DM machinery (ED_IO/get_reduced_dm.f90)."""
    from .io import get_reduced_dm
    rho = get_reduced_dm(cfg, cdm, _sites_mask(cfg, sites))
    return von_neumann_entropy(rho)


def mutual_information(cfg: EDConfig, cdm: np.ndarray, site_i: int,
                       site_j: int) -> float:
    """Two-site mutual information I2 = s_i + s_j - s_ij from the
    cluster DM (the pairwise correlation measure of Walsh et al. PRL
    122, 067203 / PRB 100, 245109)."""
    si = site_entanglement_entropy(cfg, cdm, [site_i])
    sj = site_entanglement_entropy(cfg, cdm, [site_j])
    sij = site_entanglement_entropy(cfg, cdm, [site_i, site_j])
    return si + sj - sij


def single_particle_density_matrix(cfg: EDConfig,
                                   state: DiagState) -> np.ndarray:
    """<c^+_a c_b> over impurity levels: [Nlat,Nlat,Nspin,Nspin,Norb,Norb]
    (ED_OBSERVABLES.f90:594-686; spin-diagonal)."""
    nlat, norb, nimp, ns = cfg.nlat, cfg.norb, cfg.nimp, cfg.ns
    nspin = cfg.nspin
    out = np.zeros((nlat, nlat, nspin, nspin, norb, norb), np.complex128)

    for st, peso in _state_weights(cfg, state):
        dstate = _device_occs(cfg, st, ns)
        if dstate is not None:
            # diagonal from the device densities, off-diagonals from one
            # device hop contraction per spin factor
            vec, shape2d, _, _, states_up, states_dw = dstate
            pu, pd = _device_reductions(cfg, dstate, False)[:2]
            pairs = [(a, b) for a in range(nimp) for b in range(nimp)
                     if a != b]
            for s in range(nspin):
                vals = obsdev.hop_sums_device(
                    vec, shape2d, [(a, b, 1.0) for a, b in pairs],
                    states_up if s == 0 else states_dw, 1 if s == 0 else 0)
                for a in range(nimp):
                    ila, ioa = divmod(a, norb)
                    out[ila, ila, s, s, ioa, ioa] += \
                        peso * (pu if s == 0 else pd)[a]
                for (a, b), val in zip(pairs, vals):
                    ila, ioa = divmod(a, norb)
                    ilb, iob = divmod(b, norb)
                    out[ila, ilb, s, s, ioa, iob] += peso * val
            continue
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
