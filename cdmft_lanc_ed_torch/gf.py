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
  prefactor -i, and complex injections run on the complex pair kit, or,
  when the target sector's operator is real (a complex bath-basis element
  at zero weight), on its two real planes (``kit.py`` chooses the kit);
* every injection that targets the same (N_up, N_dw) sector and kind runs
  in one batched tridiagonalisation on the device (``ed_gf_precision``:
  f64/complex128 by default, f32/complex64 on the fused CUDA H·v);
* a large target sector (Ns >= 16) takes the block-sparse kits of
  ``ops/large.py`` with the batch folded into the SpMM width (the JAX
  package's gf.py:364-416, single chip), or, with a mesh of a "dw" axis
  installed, the dw-sharded appliers of ``parallel/sharded_large.py``
  (gf.py:320-365: each rank runs its rows of every chain); a retained
  state on the card is excited on the card, and its injections are built
  there chunk by chunk, so no large vector crosses to the host;
* Sigma = G0^{-1} - G^{-1} is one batched complex128 inversion over all
  frequencies on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import kit
from .bath import BathBasis, DmftBath, basis_lso_of, invg0_bath_lso
from .config import EDConfig
from .device import budget_bytes
from .diag import DiagState, SectorBuilder
from .ops import lanczos
from .parallel import sharded_large
from .utils import fock
from .utils.reshape import lso2nnn, nnn2lso
from .utils.timer import count, span, to_host


# ---------------------------------------------------------------------------
# frequency grids (allocate_grids, ED_GF_SHARED.f90:43-55)
# ---------------------------------------------------------------------------

def matsubara_grid(cfg: EDConfig) -> np.ndarray:
    return np.pi / cfg.beta * (2 * np.arange(cfg.lmats) + 1)


def realaxis_grid(cfg: EDConfig) -> np.ndarray:
    return np.linspace(cfg.wini, cfg.wfin, cfg.lreal)


def tau_grid(cfg: EDConfig) -> np.ndarray:
    return np.linspace(0.0, cfg.beta, cfg.ltau)


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

    def evaluate_tau(self, key, tau: np.ndarray, beta: float) -> np.ndarray:
        """Imaginary-time G(tau), 0 <= tau <= beta, from the Lehmann poles:
        G(tau) = -sum_k w_k e^{-tau p_k} / (1 + e^{-beta p_k}),
        evaluated in the overflow-safe branch per pole sign."""
        p, w = self.flat(key)
        if len(p) == 0:
            return np.zeros(len(tau))
        tau = np.asarray(tau)[:, None]
        pp = p[None, :]
        pos = pp >= 0
        val = np.where(
            pos,
            np.exp(-tau * np.where(pos, pp, 0.0))
            / (1.0 + np.exp(-beta * np.where(pos, pp, 0.0))),
            np.exp((beta - tau) * np.where(pos, 0.0, pp))
            / (np.exp(beta * np.where(pos, 0.0, pp)) + 1.0))
        return -(val * w[None, :].real).sum(axis=1)


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


def base_excitations(cfg: EDConfig, v2d, nup: int, ndw: int,
                     ispin: int, create: bool):
    """All impurity-level excitations O_a|psi>, a=0..Nimp-1, as flattened
    vectors in the target sector: (vectors [Nimp, jdim] or None,
    (jnup, jndw)).  A device ``v2d`` (a large sector's state) is excited
    on its device by index scatters (the JAX package's gf.py:169-196)."""
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
    if isinstance(v2d, torch.Tensor):
        dev = v2d.device
        out = torch.zeros((nimp, len(tgt_dw), len(tgt_up)), dtype=v2d.dtype,
                          device=dev)
        for a in range(nimp):
            src, tgts = (src_up, tgt_up) if ispin == 0 else (src_dw, tgt_dw)
            tgt, sgn = fock.op_map(src, tgts, a, create)
            sel = np.nonzero(tgt >= 0)[0]
            t_sel = torch.as_tensor(sel, device=dev)
            t_tgt = torch.as_tensor(tgt[sel], device=dev)
            t_sgn = torch.as_tensor(sgn[sel]).to(device=dev, dtype=v2d.dtype)
            if ispin == 0:
                out[a][:, t_tgt] = v2d[:, t_sel] * t_sgn
            else:
                out[a][t_tgt, :] = v2d[t_sel, :] * t_sgn[:, None]
        return out.reshape(nimp, -1), (jnup, jndw)
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
    # rows of one (state, spin, create): nimp diagonal, nimp (nimp - 1)
    # (a + b) pairs, as many (a ± i b) pairs with chan4
    nchan4 = nimp * (nimp - 1) if chan4 else 0
    nrows = nimp * nimp + nchan4
    for istate, st in enumerate(state.state_list):
        nup, ndw = fock.get_quantum_numbers(st.isector, ns)
        ei = st.energy
        dim_up = len(fock.sector_states(ns, nup))
        dim_dw = len(fock.sector_states(ns, ndw))
        vec = st.get_vector(ns)
        on_dev = isinstance(vec, torch.Tensor)
        v2d = (vec if on_dev else np.asarray(vec)).reshape(dim_dw, dim_up)
        for ispin in range(cfg.nspin):
            for create in (True, False):
                with span("gf.inject", rows=nrows, chan4=chan4,
                          on_dev=on_dev):
                    base, (jnup, jndw) = base_excitations(
                        cfg, v2d, nup, ndw, ispin, create)
                    if base is None:
                        continue
                    isign = +1 if create else -1
                    # injection recipe (a, b, ph): c_a, c_a + c_b, and
                    # (chan4) c_a + ph c_b with ph = +i (add) / -i (del),
                    # reference ED_GF_NORMAL.f90:584-660
                    recipe = [(a, None, None) for a in range(nimp)]
                    meta = [((a, a), 1.0 + 0j, istate, ei, isign, ispin)
                            for a in range(nimp)]
                    for a in range(nimp):
                        for b in range(nimp):
                            if a == b:
                                continue
                            recipe.append((a, b, None))
                            meta.append(((a, b), 1.0 + 0j, istate, ei,
                                         isign, ispin))
                            if chan4:
                                recipe.append((a, b, 1j if create else -1j))
                                meta.append(((a, b), -1j, istate, ei, isign,
                                             ispin))
                    count("gf.injections", nrows)
                    count("gf.injections.chan4", nchan4)
                    rows = _Injections(base, recipe)
                    if on_dev and kit.large_sector(ns, jnup, jndw):
                        # built on the card, chunk by chunk
                        is_real = not (base.is_complex() or chan4)
                        jobs.setdefault((jnup, jndw, is_real), []).append(
                            (rows, meta))
                        continue
                    stacked = rows.take(0, len(recipe))
                    if on_dev:
                        stacked = to_host(stacked)
                    is_real = not (np.iscomplexobj(stacked)
                                   and np.abs(stacked.imag).max() > 0.0)
                    if is_real:
                        stacked = np.real(stacked)
                    jobs.setdefault((jnup, jndw, is_real), []).append(
                        (stacked, meta))

    # --- one batched tridiagonalisation per target-sector group ---------
    for (jnup, jndw, is_real), entries in jobs.items():
        meta = [m for e in entries for m in e[1]]
        with span("gf.chains", sector=(jnup, jndw), rows=len(meta),
                  large=kit.large_sector(ns, jnup, jndw)):
            op = build(jnup, jndw)
            nlanc = min(op.dim, cfg.lanc_ngfiter)
            if kit.is_large(op):
                chains = _chains_large(entries, op, is_real, nlanc, gf_dtype,
                                       device)
            else:
                chains = _chains_dense(entries, op, is_real, nlanc, gf_dtype,
                                       device, nimp)
            for lo, (alphas, betas, norms) in chains:
                for k, ((a, b), vfac, istate, ei, isign, ispin) in \
                        enumerate(meta[lo:lo + len(norms)]):
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


class _Injections:
    """The injection rows of one (state, spin, create): ``recipe`` entries
    (a, b, ph) give c_a (b None), c_a + c_b (ph None) or c_a + ph c_b of
    the base excitations ``base`` [Nimp, jdim] (host array or device
    tensor), built only when taken."""

    def __init__(self, base, recipe):
        self.base = base
        self.recipe = recipe

    def __len__(self):
        return len(self.recipe)

    def take(self, lo: int, hi: int):
        base = self.base
        rows = [base[a] if b is None else
                base[a] + base[b] if ph is None else base[a] + ph * base[b]
                for a, b, ph in self.recipe[lo:hi]]
        return torch.stack(rows) if isinstance(base, torch.Tensor) \
            else np.stack(rows)


def _chains_dense(entries, op, is_real, nlanc, gf_dtype, device, nimp):
    """Yields (first row, (alphas, betas, norms)) of the host injection
    batch ``entries`` on the dense-factor kits, chunked so the Krylov
    working set stays bounded.  Complex injections on a real operator
    take its two real planes (the 4-channel scheme of a problem whose H
    is real: the JAX package's gf.py:394-413)."""
    batch = np.concatenate([e[0] for e in entries])
    jdim = batch.shape[1]
    planes = 1 if is_real else 2
    rows_max = max(nimp, int(budget_bytes(device, 0.25)
                             / max(jdim * 8 * 3 * planes, 1)))
    k = kit.kit_for(op, gf_dtype, device, complex_vectors=not is_real)
    for lo in range(0, len(batch), rows_max):
        yield lo, lanczos.tridiag(k.apply, k.embed(batch[lo:lo + rows_max]),
                                  nlanc, op=k.dev, dtype=k.vectors)


def _chains_large(entries, op, is_real, nlanc, gf_dtype, device):
    """Yields (first row, (alphas, betas, norms)) on the tile kits of a
    target sector beyond the dense-factor limit (a real H's real tiles
    take complex injections as they are), the batch folded into the SpMM
    width.  Rows are built on the device chunk by chunk, each chunk
    holding its f64 start rows, the chain's three vectors and the folded
    applier's temporaries within a quarter of the device memory (at
    Ns=16 a few rows: one f32 vector of the (9,8) sector is 0.6 GB).
    With a "dw" mesh installed the chains run on the sharded tile kit:
    each rank takes its rows of the start rows and the exchanges add
    four vector copies to the working set."""
    planes = 1 if is_real else 2
    itemsize = torch.empty((), dtype=gf_dtype).element_size()
    k = kit.kit_for(op, gf_dtype, device, complex_vectors=not is_real,
                    shard_from=0, fold=True)
    if isinstance(k.dev, sharded_large.ShardedLargeRealOp):
        row_bytes = planes * (8 * k.dev.ddp * k.dev.dup
                              + 12 * itemsize * k.dim_p)
    else:
        row_bytes = k.dim_p * planes * (8 + 8 * itemsize)
    rows_max = max(1, int(budget_bytes(device, 0.25) // row_bytes))
    nrows = sum(len(e[1]) for e in entries)
    for lo in range(0, nrows, rows_max):
        v0 = k.embed(_take_rows(entries, lo, min(nrows, lo + rows_max),
                                device))
        yield lo, lanczos.tridiag(k.apply, v0, nlanc, op=k.dev,
                                  dtype=k.vectors)
        del v0


def _take_rows(entries, lo: int, hi: int, device) -> torch.Tensor:
    """Rows lo..hi of the concatenated injection batch, as one tensor on
    ``device`` (host entries are copied over)."""
    parts, i0 = [], 0
    for src, meta in entries:
        a, b = max(lo, i0) - i0, min(hi, i0 + len(meta)) - i0
        if a < b:
            part = src.take(a, b) if isinstance(src, _Injections) \
                else src[a:b]
            parts.append(torch.as_tensor(part).to(device))
        i0 += len(meta)
    if any(p.is_complex() for p in parts):
        parts = [p.to(torch.complex128) for p in parts]
    return torch.cat(parts)


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
                if isinstance(v, torch.Tensor):     # reduced on the card
                    return not v.is_complex() or float(
                        to_host(v.imag.abs().max())) == 0.0
                return (not np.iscomplexobj(v)
                        or np.abs(v.imag).max(initial=0) == 0)
            force_sym = all(_vec_is_real(st) for st in state.state_list)
        if force_sym:
            log("gf: real problem detected -> symmetric 2-channel scheme")

    spec, max_exc = build_gf_normal(cfg, state, build, device, log,
                                    force_symmetric=force_sym)
    with span("gf.sigma"):
        gmats = evaluate_gf_nnn(spec, cfg, zmats)
        greal = evaluate_gf_nnn(spec, cfg, zreal)

        # ---- Sigma = G0^{-1} - G^{-1} (build_sigma_normal), complex128 on
        # the device ----
        def lso_freq(g):      # [.,.,.,.,.,.,L] -> [L, Nlso, Nlso] on device
            a = np.moveaxis(nnn2lso(g, nlat, nspin, norb), -1, 0)
            return torch.as_tensor(np.ascontiguousarray(a)).to(device)

        def to_nnn(a_lso_freq: torch.Tensor):
            return lso2nnn(np.moveaxis(to_host(a_lso_freq), 0, -1),
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
