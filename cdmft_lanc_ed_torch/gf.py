"""Green's functions: batched GF-Lanczos, pole/weight spectra, self-energy.

Port of the dense-factor path of the JAX package's ``gf.py`` (continued
fraction via Lanczos tridiagonalisation in the particle-added/removed
sector, ED_GF_NORMAL.f90):

* the base excitations ``c^+_a|psi>`` / ``c_a|psi>`` are built once per
  (state, spin) as index gathers; pair injections are combinations of
  them;
* a real Hamiltonian with real retained eigenvectors has G_ij = G_ji
  exactly: the symmetric 2-channel scheme (injections a, a+b), every
  injection one real plane on the real kit;
* otherwise the 4-channel scheme adds the (a ± i b) injections with
  prefactor -i, and complex injections run on the complex pair kit;
* every injection that targets the same (N_up, N_dw) sector and kind runs
  in one batched tridiagonalisation on the device (``ed_gf_precision``:
  f64/complex128 by default, f32/complex64 on the fused CUDA H·v);
* Sigma = G0^{-1} - G^{-1} is one batched complex128 inversion over all
  frequencies on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .bath import BathBasis, DmftBath, basis_lso_of, invg0_bath_lso
from .config import EDConfig
from .device import budget_bytes
from .diag import DiagState, SectorBuilder, _kit
from .ops import lanczos, split
from .utils import fock
from .utils.reshape import lso2nnn, nnn2lso


# ---------------------------------------------------------------------------
# frequency grids (allocate_grids, ED_GF_SHARED.f90:43-55)
# ---------------------------------------------------------------------------

def matsubara_grid(cfg: EDConfig) -> np.ndarray:
    return np.pi / cfg.beta * (2 * np.arange(cfg.lmats) + 1)


def realaxis_grid(cfg: EDConfig) -> np.ndarray:
    return np.linspace(cfg.wini, cfg.wfin, cfg.lreal)


# ---------------------------------------------------------------------------
# pole/weight spectrum store (GFmatrix type, ED_VARS_GLOBAL.f90:76-100)
# ---------------------------------------------------------------------------

@dataclass
class GFChannel:
    poles: np.ndarray      # [Nexc] real
    weights: np.ndarray    # [Nexc] complex


class GFSpectrum:
    """impGmatrix equivalent: per component (ilat,jlat,ispin,iorb,jorb) a
    list over states of lists of channels.

    ``symmetric`` records which off-diagonal scheme built the spectrum
    (2-channel symmetric or 4-channel), so that later evaluations
    recombine it the same way; None means "use the config flag"."""

    def __init__(self):
        self.data: Dict[Tuple[int, int, int, int, int],
                        List[List[GFChannel]]] = {}
        self.symmetric: Optional[bool] = None

    def add_channel(self, key, istate: int, chan: GFChannel):
        comp = self.data.setdefault(key, [])
        while len(comp) <= istate:
            comp.append([])
        comp[istate].append(chan)

    def flat(self, key):
        """Concatenated (poles, weights) over all states/channels."""
        poles, weights = [], []
        for st in self.data.get(key, []):
            for ch in st:
                if len(ch.poles):
                    poles.append(ch.poles)
                    weights.append(ch.weights)
        if not poles:
            return np.zeros(0), np.zeros(0, np.complex128)
        return np.concatenate(poles), np.concatenate(weights)

    def evaluate(self, key, z: np.ndarray) -> np.ndarray:
        """G(z) = sum_k w_k / (z - p_k) (ed_gf_cluster rebuild,
        ED_IO/gf_cluster.f90:1-88); host numpy, the pole sums are tiny."""
        p, w = self.flat(key)
        if len(p) == 0:
            return np.zeros(len(z), np.complex128)
        zz = np.asarray(z)[:, None]
        return np.sum(w[None, :] / (zz - p[None, :]), axis=1)


# ---------------------------------------------------------------------------
# excitation injections (ED_GF_NORMAL.f90:174-199 redesigned)
# ---------------------------------------------------------------------------

def _apply_up(v2d: np.ndarray, tgt: np.ndarray, sgn: np.ndarray,
              jdim_up: int) -> np.ndarray:
    """(op acting on the up factor): out[idw, tgt[iup]] = sgn*v[idw, iup]."""
    out = np.zeros((v2d.shape[0], jdim_up), dtype=v2d.dtype)
    sel = tgt >= 0
    out[:, tgt[sel]] = v2d[:, sel] * sgn[sel]
    return out


def _apply_dw(v2d: np.ndarray, tgt: np.ndarray, sgn: np.ndarray,
              jdim_dw: int) -> np.ndarray:
    """(op acting on the dw factor): out[tgt[idw], iup] = sgn*v[idw, iup]."""
    out = np.zeros((jdim_dw, v2d.shape[1]), dtype=v2d.dtype)
    sel = tgt >= 0
    out[tgt[sel], :] = v2d[sel, :] * sgn[sel][:, None]
    return out


def base_excitations(cfg: EDConfig, v2d: np.ndarray, nup: int, ndw: int,
                     ispin: int, create: bool):
    """All impurity-level excitations O_a|psi>, a=0..Nimp-1, as flattened
    host vectors in the target sector: (vectors [Nimp, jdim] or None,
    (jnup, jndw))."""
    ns, nimp = cfg.ns, cfg.nimp
    dn = 1 if create else -1
    if ispin == 0:
        jnup, jndw = nup + dn, ndw
    else:
        jnup, jndw = nup, ndw + dn
    if not (0 <= jnup <= ns and 0 <= jndw <= ns):
        return None, (jnup, jndw)
    src_up = fock.sector_states(ns, nup)
    src_dw = fock.sector_states(ns, ndw)
    tgt_up = fock.sector_states(ns, jnup)
    tgt_dw = fock.sector_states(ns, jndw)
    out = np.zeros((nimp, len(tgt_dw) * len(tgt_up)), dtype=v2d.dtype)
    for a in range(nimp):
        if ispin == 0:
            tgt, sgn = fock.op_map(src_up, tgt_up, a, create)
            out[a] = _apply_up(v2d, tgt, sgn, len(tgt_up)).ravel()
        else:
            tgt, sgn = fock.op_map(src_dw, tgt_dw, a, create)
            out[a] = _apply_dw(v2d, tgt, sgn, len(tgt_dw)).ravel()
    return out, (jnup, jndw)


# ---------------------------------------------------------------------------
# pole/weight extraction (add_to_lanczos_gf_normal, ED_GF_NORMAL.f90:915-975)
# ---------------------------------------------------------------------------

def _chain_to_poles(alphas: np.ndarray, betas: np.ndarray, norm0: float,
                    vfac: complex, ei: float, egs: float, isign: int,
                    cfg: EDConfig, zeta: float,
                    beta_floor: float = 1e-16) -> GFChannel:
    """One Lanczos chain -> (poles, weights); total weight prefactor
    vfac*norm0^2*wBoltz/Z.  ``beta_floor`` (invariant-subspace truncation
    relative to the chain scale) tracks the chain dtype: 1e-16 for f64,
    1e-6 for f32 chains, which break down near eps(f32)."""
    if norm0 == 0.0:
        return GFChannel(np.zeros(0), np.zeros(0, np.complex128))
    m = len(alphas)
    scale = max(1.0, float(np.abs(alphas).max(initial=1.0)))
    for j in range(len(betas)):
        if betas[j] < beta_floor * scale:
            m = j + 1
            break
    theta, z0 = lanczos.tridiag_eigh(alphas[:m], betas[:m - 1])
    if cfg.finite_temp:
        arg = cfg.beta * (ei - egs)
        boltz = np.exp(-arg) if arg < 200 else 0.0
        pesobz = vfac * norm0 ** 2 * boltz / zeta
    else:
        pesobz = vfac * norm0 ** 2 / zeta
    de = theta - ei
    return GFChannel(poles=isign * de, weights=pesobz * z0 ** 2)


# ---------------------------------------------------------------------------
# main GF build
# ---------------------------------------------------------------------------

@dataclass
class GFResult:
    spectrum: GFSpectrum
    # arrays shaped [Nlat,Nlat,Nspin,Nspin,Norb,Norb,L]
    gmats: np.ndarray
    greal: np.ndarray
    smats: np.ndarray
    sreal: np.ndarray
    g0mats: np.ndarray
    g0real: np.ndarray
    max_exc: float
    wm: np.ndarray
    wr: np.ndarray


def build_gf_normal(cfg: EDConfig, state: DiagState, build: SectorBuilder,
                    device: torch.device, log=lambda s: None,
                    force_symmetric: bool = False
                    ) -> Tuple[GFSpectrum, float]:
    """Fill the pole/weight spectrum for all (site,orb,spin) components
    (build_gf_normal, ED_GF_NORMAL.f90:38-104): Nimp diagonal injections
    plus the (a+b) pairs per (state, spin, create), and the (a ± i b)
    pairs unless ``cfg.ed_gf_symmetric`` or ``force_symmetric`` selects
    the 2-channel scheme."""
    ns, nimp, norb = cfg.ns, cfg.nimp, cfg.norb
    spec = GFSpectrum()
    egs = state.state_list.emin
    zeta = state.zeta_function
    max_exc = -np.inf
    chan4 = not (cfg.ed_gf_symmetric or force_symmetric)
    spec.symmetric = not chan4
    # ed_gf_precision="single": f32/complex64 chains on the fused CUDA
    # kernels; pole weights and the continued-fraction evaluation stay f64
    gf_single = cfg.ed_gf_precision == "single"
    gf_dtype = torch.float32 if gf_single else torch.float64
    beta_floor = 1e-6 if gf_single else 1e-16

    # --- all injection batches, grouped by target sector and kind: every
    # injection that targets the same (jnup, jndw) sector, from any
    # retained state, runs in ONE batched tridiagonalisation ---
    jobs: Dict[Tuple[int, int, bool], list] = {}
    for istate, st in enumerate(state.state_list):
        nup, ndw = fock.get_quantum_numbers(st.isector, ns)
        ei = st.energy
        dim_up = len(fock.sector_states(ns, nup))
        dim_dw = len(fock.sector_states(ns, ndw))
        v2d = np.asarray(st.get_vector(ns)).reshape(dim_dw, dim_up)
        for ispin in range(cfg.nspin):
            for create in (True, False):
                base, (jnup, jndw) = base_excitations(
                    cfg, v2d, nup, ndw, ispin, create)
                if base is None:
                    continue
                isign = +1 if create else -1
                vecs = [base[a] for a in range(nimp)]
                meta = [((a, a), 1.0 + 0j, istate, ei, isign, ispin)
                        for a in range(nimp)]
                for a in range(nimp):
                    for b in range(nimp):
                        if a == b:
                            continue
                        vecs.append(base[a] + base[b])
                        meta.append(((a, b), 1.0 + 0j, istate, ei, isign,
                                     ispin))
                        if chan4:
                            # reference: add c^+_a + i c^+_b ;
                            # del c_a - i c_b (ED_GF_NORMAL.f90:584-660)
                            ph = 1j if create else -1j
                            vecs.append(base[a] + ph * base[b])
                            meta.append(((a, b), -1j, istate, ei, isign,
                                         ispin))
                stacked = np.stack(vecs)
                is_real = not (np.iscomplexobj(stacked)
                               and np.abs(stacked.imag).max() > 0.0)
                if is_real:
                    stacked = np.real(stacked)
                jobs.setdefault((jnup, jndw, is_real), []).append(
                    (stacked, meta))

    # --- one batched tridiagonalisation per target-sector group ---------
    for (jnup, jndw, is_real), entries in jobs.items():
        batch = np.concatenate([e[0] for e in entries])
        meta = [m for e in entries for m in e[1]]
        jdim = batch.shape[1]
        planes = 1 if is_real else 2
        rows_max = max(nimp, int(budget_bytes(device, 0.25)
                                 / max(jdim * 8 * 3 * planes, 1)))
        nlanc = min(jdim, cfg.lanc_ngfiter)
        op = build(jnup, jndw)
        apply1, dev, real_op, _dim_p, embed, _extract = _kit(op, gf_dtype,
                                                             device)
        # real injections on a real operator stay one real plane; all
        # others run complex on the pair kit (a real operator's with zero
        # imaginary parts)
        if real_op and not is_real:
            apply1 = split.apply_pair_flat
            dev = split.build_pair_padded(op, dtype=gf_dtype,
                                          device=device)[0]
        tridiag = (lanczos.lanczos_tridiag_batched_real
                   if real_op and is_real
                   else lanczos.lanczos_tridiag_batched_split)
        for lo in range(0, len(meta), rows_max):
            sub = batch[lo:lo + rows_max]
            sub_meta = meta[lo:lo + rows_max]
            alphas, betas, norms = tridiag(apply1, embed(sub), nlanc,
                                           op=dev, dtype=gf_dtype)
            for k, ((a, b), vfac, istate, ei, isign, ispin) in \
                    enumerate(sub_meta):
                ch = _chain_to_poles(alphas[k], betas[k],
                                     float(norms[k]), vfac, ei, egs,
                                     isign, cfg, zeta,
                                     beta_floor=beta_floor)
                if len(ch.poles):
                    d = ch.poles * isign   # = de >= 0 excitation energies
                    max_exc = max(max_exc, float(d.max()))
                ilat, iorb = divmod(a, norb)
                jlat, jorb = divmod(b, norb)
                spec.add_channel((ilat, jlat, ispin, iorb, jorb),
                                 istate, ch)
        log(f"gf: target sector ({jnup},{jndw}) "
            f"{len(meta)} injections done")
    return spec, max_exc


def evaluate_gf_nnn(spec: GFSpectrum, cfg: EDConfig,
                    z: np.ndarray) -> np.ndarray:
    """Rebuild the full cluster GF at arbitrary complex frequencies from the
    stored pole/weight spectrum, including the off-diagonal recombination
    G_ij = (G_(i+j) - fac G_ii - fac G_jj) / 2 with fac 1 (2-channel) or
    1 - i (4-channel, whose (a ± i b) channels carry the -i prefactor)
    (ed_gf_cluster, ED_IO/gf_cluster.f90:1-88)."""
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    out = np.zeros((nlat, nlat, nspin, nspin, norb, norb, len(z)),
                   np.complex128)
    sym = spec.symmetric if spec.symmetric is not None \
        else cfg.ed_gf_symmetric
    fac = 1.0 - (0.0 if sym else 1j)
    for ispin in range(nspin):
        for ilat in range(nlat):
            for iorb in range(norb):
                out[ilat, ilat, ispin, ispin, iorb, iorb] = \
                    spec.evaluate((ilat, ilat, ispin, iorb, iorb), z)
        for ilat in range(nlat):
            for jlat in range(nlat):
                for iorb in range(norb):
                    for jorb in range(norb):
                        if ilat == jlat and iorb == jorb:
                            continue
                        g = spec.evaluate((ilat, jlat, ispin, iorb, jorb), z)
                        gii = out[ilat, ilat, ispin, ispin, iorb, iorb]
                        gjj = out[jlat, jlat, ispin, ispin, jorb, jorb]
                        out[ilat, jlat, ispin, ispin, iorb, jorb] = \
                            0.5 * (g - fac * gii - fac * gjj)
    return out


def build_gf_and_sigma(cfg: EDConfig, hb: BathBasis, bath: DmftBath,
                       imp_hloc: np.ndarray, state: DiagState,
                       build: SectorBuilder, device: torch.device,
                       log=lambda s: None) -> GFResult:
    """buildgf_impurity equivalent (ED_GREENS_FUNCTIONS.f90:23-56):
    spectrum -> G(iw), G(w) -> off-diagonal recombination -> Sigma."""
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    wm = matsubara_grid(cfg)
    wr = realaxis_grid(cfg)
    zmats = 1j * wm
    zreal = wr + 1j * cfg.eps

    # real H (Hloc + bath basis; V, U, Jx/Jp are real by construction)
    # and real retained eigenvectors => G_ij = G_ji: the 2-channel scheme;
    # anything complex takes the 4-channel scheme
    force_sym = False
    if not cfg.ed_gf_symmetric:
        real_h = (np.abs(np.asarray(imp_hloc).imag).max(initial=0) == 0
                  and np.abs(np.asarray(hb.basis).imag).max(initial=0) == 0)
        if real_h:
            def _vec_is_real(st):
                v = st.get_vector(cfg.ns)
                return (not np.iscomplexobj(v)
                        or np.abs(v.imag).max(initial=0) == 0)
            force_sym = all(_vec_is_real(st) for st in state.state_list)
        if force_sym:
            log("gf: real problem detected -> symmetric 2-channel scheme")

    spec, max_exc = build_gf_normal(cfg, state, build, device, log,
                                    force_symmetric=force_sym)
    gmats = evaluate_gf_nnn(spec, cfg, zmats)
    greal = evaluate_gf_nnn(spec, cfg, zreal)

    # ---- Sigma = G0^{-1} - G^{-1} (build_sigma_normal), complex128 on
    # the device ----
    def lso_freq(g):      # [.,.,.,.,.,.,L] -> [L, Nlso, Nlso] on device
        a = np.moveaxis(nnn2lso(g, nlat, nspin, norb), -1, 0)
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    def to_nnn(a_lso_freq: torch.Tensor):
        return lso2nnn(np.moveaxis(a_lso_freq.cpu().numpy(), 0, -1),
                       nlat, nspin, norb)

    hloc_lso = torch.as_tensor(np.ascontiguousarray(
        nnn2lso(np.asarray(imp_hloc, np.complex128), nlat, nspin,
                norb))).to(device)
    basis_lso = basis_lso_of(cfg, hb, device)
    v = torch.as_tensor(bath.v).to(device)
    lam = torch.as_tensor(bath.lam).to(device)
    invg0_m = invg0_bath_lso(torch.as_tensor(zmats).to(device), hloc_lso,
                             cfg.xmu, v, lam, basis_lso)
    invg0_r = invg0_bath_lso(torch.as_tensor(zreal).to(device), hloc_lso,
                             cfg.xmu, v, lam, basis_lso)
    smats = to_nnn(invg0_m - torch.linalg.inv(lso_freq(gmats)))
    sreal = to_nnn(invg0_r - torch.linalg.inv(lso_freq(greal)))
    g0mats = to_nnn(torch.linalg.inv(invg0_m))
    g0real = to_nnn(torch.linalg.inv(invg0_r))
    return GFResult(spectrum=spec, gmats=gmats, greal=greal, smats=smats,
                    sreal=sreal, g0mats=g0mats, g0real=g0real,
                    max_exc=max_exc, wm=wm, wr=wr)
