"""Per-sector Hamiltonian assembly (host side, vectorised NumPy).

Copy of the JAX package's ``ops/sector_ham.py`` without the C++ table
builders (the numpy path only).  Redesign of the reference sparse builder
(the reference's ED_HAMILTONIAN_SPARSE_HxV.f90:40-152 and
ED_HAMILTONIAN/sparse/{H_local,H_up,H_dw,H_non_local}.f90).  The sector
Hamiltonian keeps the reference's exact 4-term tensor-product split

    H = D  +  I_dw ⊗ H_up  +  H_dw ⊗ I_up  +  H_nd

but with compact data layouts:

* ``H_up``/``H_dw`` are padded-ELL blocks (fixed nnz/row) instead of
  linked-list CSR, rows gathered contiguously.
* The diagonal ``D`` is kept in **factorised form**
  ``D[idw,iup] = adw[idw] + aup[iup] + Ndw[idw]·W·Nup[iup] + const``
  (the Kanamori density-density interaction is bilinear in the per-spin
  occupations), so it can be fused into the SpMV without storing a
  Dim-sized array.
* The spin-exchange/pair-hopping block ``H_nd`` (reference builds a giant
  distributed COO + allgather, ED_HAMILTONIAN_SPARSE_HxV.f90:299-313) is
  represented **factorised** as a sum of Kronecker products of one-hop
  maps: H_nd = Σ_t amp_t · O^dw_t ⊗ O^up_t.  Each factor is a
  permutation-with-sign gather — no allgather needed, and it shards with
  the same transpose machinery as H_up/H_dw.

The sector vector layout is ``v[DimDw, DimUp]`` (C-order == reference flat
index i = iup + idw*DimUp, ED_SETUP.f90:547-560).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..config import EDConfig
from ..utils import fock
from ..utils.timer import span


# ---------------------------------------------------------------------------
# ELL container
# ---------------------------------------------------------------------------

@dataclass
class EllMatrix:
    """Padded-ELL sparse square matrix (rows gather: out[r]=Σ_k val[r,k]·v[col[r,k]])."""
    cols: np.ndarray   # [n, K] int32, zero-padded
    vals: np.ndarray   # [n, K] complex
    n: int
    nnz: int

    def to_dense(self) -> np.ndarray:
        h = np.zeros((self.n, self.n), dtype=self.vals.dtype)
        rows = np.repeat(np.arange(self.n), self.cols.shape[1])
        np.add.at(h, (rows, self.cols.ravel()), self.vals.ravel())
        return h

    def matvec(self, v: np.ndarray) -> np.ndarray:
        """NumPy reference SpMM: v is [n, ...]; gathers rows of v."""
        return np.einsum("rk,rk...->r...", self.vals, v[self.cols])


def _coo_to_ell(n: int, rows, cols, vals, dtype=np.complex128,
                min_k: int = 1) -> EllMatrix:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=dtype)
    if len(rows) == 0:
        return EllMatrix(np.zeros((n, min_k), np.int32),
                         np.zeros((n, min_k), dtype), n, 0)
    # accumulate duplicate (row,col) entries (sp_insert_element semantics,
    # ED_SPARSE_MATRIX.f90:254-284)
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, first = np.unique(key_s, return_index=True)
    acc = np.add.reduceat(vals[order], first)
    r = (uniq // n).astype(np.int64)
    c = (uniq % n).astype(np.int64)
    counts = np.bincount(r, minlength=n)
    k = max(int(counts.max()), min_k)
    slot = np.arange(len(r)) - np.concatenate(([0], np.cumsum(counts)))[r]
    ell_cols = np.zeros((n, k), np.int32)
    ell_vals = np.zeros((n, k), dtype)
    ell_cols[r, slot] = c
    ell_vals[r, slot] = acc
    return EllMatrix(ell_cols, ell_vals, n, len(uniq))


# ---------------------------------------------------------------------------
# factored non-local (Jx/Jp) term
# ---------------------------------------------------------------------------

@dataclass
class KronHopTerm:
    """amp · O^dw ⊗ O^up with one-hop factors stored as inverse gather maps.

    ``up_src[iup]`` is the source column feeding target ``iup`` (or -1),
    ``up_sgn`` the fermionic sign; likewise for dw.  Application:
    out[idw,iup] += amp * dw_sgn[idw]*up_sgn[iup] * v[dw_src[idw], up_src[iup]].
    """
    amp: complex
    up_src: np.ndarray
    up_sgn: np.ndarray
    dw_src: np.ndarray
    dw_sgn: np.ndarray

    def matvec(self, v: np.ndarray) -> np.ndarray:
        g = v[np.maximum(self.dw_src, 0)][:, np.maximum(self.up_src, 0)]
        mask = (self.dw_sgn[:, None] * self.up_sgn[None, :]).astype(v.dtype)
        return self.amp * mask * g

    def to_dense(self, dim_up: int, dim_dw: int) -> np.ndarray:
        ou = np.zeros((dim_up, dim_up))
        od = np.zeros((dim_dw, dim_dw))
        iu = np.nonzero(self.up_src >= 0)[0]
        ou[iu, self.up_src[iu]] = self.up_sgn[iu]
        idw = np.nonzero(self.dw_src >= 0)[0]
        od[idw, self.dw_src[idw]] = self.dw_sgn[idw]
        return self.amp * np.kron(od, ou)


def _invert_hop(n: int, rows, cols, signs):
    src = np.full(n, -1, dtype=np.int32)
    sgn = np.zeros(n, dtype=np.int8)
    src[rows] = cols
    sgn[rows] = signs
    return src, sgn


# ---------------------------------------------------------------------------
# sector operator
# ---------------------------------------------------------------------------

@dataclass
class SectorOperator:
    """Everything needed to apply H within one (nup,ndw) sector."""
    isector: int
    nup: int
    ndw: int
    dim_up: int
    dim_dw: int
    states_up: np.ndarray
    states_dw: np.ndarray
    # factorised diagonal
    aup: np.ndarray          # [DimUp] float64
    adw: np.ndarray          # [DimDw] float64
    w_updw: np.ndarray       # [Nimp, Nimp] float64
    n_up: np.ndarray         # [DimUp, Nimp] float64 occupations
    n_dw: np.ndarray         # [DimDw, Nimp] float64
    diag_const: float
    # hopping blocks
    h_up: EllMatrix
    h_dw: EllMatrix
    nd_terms: List[KronHopTerm] = field(default_factory=list)

    @property
    def dim(self) -> int:
        return self.dim_up * self.dim_dw

    # -- diagnostics ----------------------------------------------------
    @property
    def nnz(self) -> int:
        """Total stored+implied nonzeros of the full H (for nnz/s metrics)."""
        nnz_nd = sum(int((t.up_src >= 0).sum()) * int((t.dw_src >= 0).sum())
                     for t in self.nd_terms)
        return (self.dim
                + self.h_up.nnz * self.dim_dw
                + self.h_dw.nnz * self.dim_up
                + nnz_nd)

    def diag(self) -> np.ndarray:
        """Materialised diagonal [DimDw, DimUp]."""
        cross = self.n_dw @ self.w_updw @ self.n_up.T
        return (self.adw[:, None] + self.aup[None, :] + cross
                + self.diag_const)

    # -- NumPy reference matvec (oracle for the device kernels) ---------
    def matvec_np(self, v: np.ndarray) -> np.ndarray:
        v2 = v.reshape(self.dim_dw, self.dim_up)
        out = self.diag().astype(v2.dtype) * v2
        out += self.h_dw.matvec(v2)                      # H_dw ⊗ I
        out += self.h_up.matvec(v2.T).T                  # I ⊗ H_up
        for t in self.nd_terms:
            out += t.matvec(v2)
        return out.reshape(v.shape)

    def to_dense(self) -> np.ndarray:
        """Dense sector H (reference dump path,
        ED_HAMILTONIAN_SPARSE_HxV.f90:112-148)."""
        h = np.diag(self.diag().ravel().astype(np.complex128))
        h += np.kron(self.h_dw.to_dense(), np.eye(self.dim_up))
        h += np.kron(np.eye(self.dim_dw), self.h_up.to_dense())
        for t in self.nd_terms:
            h += t.to_dense(self.dim_up, self.dim_dw)
        return h


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

def _one_body_terms(cfg: EDConfig, imp_hloc: np.ndarray,
                    hbath_rec: np.ndarray, diag_hybr: np.ndarray,
                    spin: int) -> List[Tuple[int, int, complex]]:
    """All off-diagonal one-body amplitudes (a,b,amp) == amp·c^+_a c_b for one
    spin species.  Mirrors ED_HAMILTONIAN/sparse/H_up.f90 / H_dw.f90."""
    nlat, norb, nbath = cfg.nlat, cfg.norb, cfg.nbath
    s = 0 if spin == 0 else cfg.nspin - 1
    terms: List[Tuple[int, int, complex]] = []
    # cluster hopping (H_up.f90:8-28)
    for ilat in range(nlat):
        for jlat in range(nlat):
            for iorb in range(norb):
                for jorb in range(norb):
                    a = fock.imp_level(ilat, iorb, norb)
                    b = fock.imp_level(jlat, jorb, norb)
                    if a == b:
                        continue
                    amp = imp_hloc[ilat, jlat, s, s, iorb, jorb]
                    if amp != 0:
                        terms.append((a, b, complex(amp)))
    # intra-replica bath hopping (H_up.f90:30-56)
    for ibath in range(nbath):
        for ilat in range(nlat):
            for jlat in range(nlat):
                for iorb in range(norb):
                    for jorb in range(norb):
                        a = fock.bath_level(ilat, iorb, ibath, nlat, norb)
                        b = fock.bath_level(jlat, jorb, ibath, nlat, norb)
                        if a == b:
                            continue
                        amp = hbath_rec[ibath, ilat, jlat, s, s, iorb, jorb]
                        if amp != 0:
                            terms.append((a, b, complex(amp)))
    # imp<->bath hybridisation, both directions (H_up.f90:59-87)
    for ilat in range(nlat):
        for iorb in range(norb):
            for ibath in range(nbath):
                bl = fock.bath_level(ilat, iorb, ibath, nlat, norb)
                il = fock.imp_level(ilat, iorb, norb)
                v = diag_hybr[ilat, s, iorb, ibath]
                if v != 0:
                    terms.append((bl, il, complex(v)))
                    terms.append((il, bl, complex(v)))
    return terms


def _spin_hop_ell(states: np.ndarray,
                  terms: List[Tuple[int, int, complex]]) -> EllMatrix:
    n = len(states)
    rows_all, cols_all, vals_all = [], [], []
    for a, b, amp in terms:
        rows, cols, signs = fock.hop_entries(states, a, b)
        rows_all.append(rows)
        cols_all.append(cols)
        vals_all.append(amp * signs)
    if rows_all:
        rows_all = np.concatenate(rows_all)
        cols_all = np.concatenate(cols_all)
        vals_all = np.concatenate(vals_all)
    return _coo_to_ell(n, rows_all, cols_all, vals_all)


def build_sector_operator(cfg: EDConfig, imp_hloc: np.ndarray,
                          hbath_rec: np.ndarray, diag_hybr: np.ndarray,
                          nup: int, ndw: int) -> SectorOperator:
    """Assemble the sector Hamiltonian pieces.

    Parameters
    ----------
    imp_hloc : [Nlat,Nlat,Nspin,Nspin,Norb,Norb] complex cluster Hamiltonian
    hbath_rec : [Nbath,Nlat,Nlat,Nspin,Nspin,Norb,Norb] reconstructed bath
        Hamiltonians Σ_s λ_s H^sym_s (ED_BATH/hbath_setup.f90:240-250)
    diag_hybr : [Nlat,Nspin,Norb,Nbath] real hybridisation amplitudes
        (ED_HAMILTONIAN_SPARSE_HxV.f90:63-75)
    """
    with span("sector.build", sector=(nup, ndw)):
        ns, nimp = cfg.ns, cfg.nimp
        nlat, norb, nbath = cfg.nlat, cfg.norb, cfg.nbath
        uloc = cfg.uloc_arr
        ust, jh_ = cfg.ust, cfg.jh

        states_up = fock.sector_states(ns, nup)
        states_dw = fock.sector_states(ns, ndw)
        dim_up, dim_dw = len(states_up), len(states_dw)

        # --- per-spin diagonal fields over all Ns levels -------------------
        # (H_local.f90:20-28 impurity local + xmu; :83-93 bath diagonal)
        def spin_field(s_idx: int) -> np.ndarray:
            e = np.zeros(ns)
            for ilat in range(nlat):
                for iorb in range(norb):
                    il = fock.imp_level(ilat, iorb, norb)
                    e[il] = imp_hloc[ilat, ilat, s_idx, s_idx, iorb,
                                     iorb].real - cfg.xmu
                    if cfg.hfmode:
                        # Hartree shifts (H_local.f90:62-80)
                        e[il] += -0.5 * uloc[iorb] \
                            - 0.5 * (ust + (ust - jh_)) * (norb - 1)
                    for ibath in range(nbath):
                        bl = fock.bath_level(ilat, iorb, ibath, nlat, norb)
                        e[bl] = hbath_rec[ibath, ilat, ilat, s_idx, s_idx,
                                          iorb, iorb].real
            return e

        e_up = spin_field(0)
        e_dw = spin_field(cfg.nspin - 1)

        # occupations of impurity levels per sector state
        imp_levels = np.arange(nimp)
        n_up_full = fock.number_op(states_up, np.arange(ns))
        n_dw_full = fock.number_op(states_dw, np.arange(ns))
        n_up = n_up_full[:, :nimp]
        n_dw = n_dw_full[:, :nimp]

        # same-spin density-density: Σ_site Σ_{i<j} (Ust-Jh) n_i n_j
        # (H_local.f90:51-60)
        w_ss = np.zeros((nimp, nimp))
        w_ud = np.zeros((nimp, nimp))
        for ilat in range(nlat):
            for iorb in range(norb):
                a = fock.imp_level(ilat, iorb, norb)
                # Uloc n_up n_dw (H_local.f90:35-39)
                w_ud[a, a] = uloc[iorb]
                for jorb in range(norb):
                    if jorb == iorb:
                        continue
                    b = fock.imp_level(ilat, jorb, norb)
                    # Ust (n_up_i n_dw_j + ...) :44-50; ordered pairs
                    # double-count
                    w_ud[a, b] = ust
                    w_ss[a, b] = 0.5 * (ust - jh_)
        aup = n_up_full @ e_up + 0.5 * np.einsum(
            "ua,ab,ub->u", n_up, 2 * w_ss, n_up)
        adw = n_dw_full @ e_dw + 0.5 * np.einsum(
            "da,ab,db->d", n_dw, 2 * w_ss, n_dw)

        const = 0.0
        if cfg.hfmode:
            npairs = norb * (norb - 1) // 2
            const = nlat * (0.25 * uloc[:norb].sum()
                            + npairs * (0.25 * ust + 0.25 * (ust - jh_)))

        # --- hopping blocks ------------------------------------------------
        h_up = _spin_hop_ell(states_up,
                             _one_body_terms(cfg, imp_hloc, hbath_rec,
                                             diag_hybr, spin=0))
        h_dw = _spin_hop_ell(states_dw,
                             _one_body_terms(cfg, imp_hloc, hbath_rec,
                                             diag_hybr, spin=1))

        # --- non-local Jx/Jp terms as Kronecker factors --------------------
        # (H_non_local.f90:23-98): H_nd = Jx Σ c^+_i c_j |up ⊗ c^+_j c_i |dw
        #                               + Jp Σ c^+_i c_j |up ⊗ c^+_i c_j |dw
        nd_terms: List[KronHopTerm] = []
        if cfg.jhflag:
            for ilat in range(nlat):
                for iorb in range(norb):
                    for jorb in range(norb):
                        if iorb == jorb:
                            continue
                        a = fock.imp_level(ilat, iorb, norb)
                        b = fock.imp_level(ilat, jorb, norb)
                        if cfg.jx != 0.0:
                            ur, uc, us = fock.hop_entries(states_up, a, b)
                            dr, dc, ds = fock.hop_entries(states_dw, b, a)
                            usrc, usgn = _invert_hop(dim_up, ur, uc, us)
                            dsrc, dsgn = _invert_hop(dim_dw, dr, dc, ds)
                            nd_terms.append(KronHopTerm(cfg.jx, usrc, usgn,
                                                        dsrc, dsgn))
                        if cfg.jp != 0.0:
                            ur, uc, us = fock.hop_entries(states_up, a, b)
                            dr, dc, ds = fock.hop_entries(states_dw, a, b)
                            usrc, usgn = _invert_hop(dim_up, ur, uc, us)
                            dsrc, dsgn = _invert_hop(dim_dw, dr, dc, ds)
                            nd_terms.append(KronHopTerm(cfg.jp, usrc, usgn,
                                                        dsrc, dsgn))

        return SectorOperator(
            isector=fock.get_sector(nup, ndw, ns), nup=nup, ndw=ndw,
            dim_up=dim_up, dim_dw=dim_dw,
            states_up=states_up, states_dw=states_dw,
            aup=aup, adw=adw, w_updw=w_ud, n_up=n_up, n_dw=n_dw,
            diag_const=float(const),
            h_up=h_up, h_dw=h_dw, nd_terms=nd_terms)
