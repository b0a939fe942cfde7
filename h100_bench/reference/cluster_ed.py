"""Plain exact diagonalization of an impurity cluster with its bath.

The yardstick that decides ``correct``: from the one-body matrices and the
density-density interaction of a model (built from the same configuration
and bath that the program is handed, by ``reference/<model>.py``), it works
out the ground state of a neighbourhood of sectors, the impurity Green's
function G_ab(iw_n) of each spin, the self-energy Sigma(iw_n) and the
densities and double occupancies, with nothing but NumPy and plain
``torch`` products.  It imports nothing of the program.

Model: Ns levels per spin, the first ``nimp`` of them the impurity's; a
one-body matrix h_σ [Ns, Ns] per spin (Hermitian, real or complex; the
chemical potential included, no Hartree shift) and, on impurity levels,
density-density terms::

    H = Σ_σ Σ_ab h_σ,ab c†_aσ c_bσ
        + Σ_ab W↑↓_ab x_a↑ x_b↓ + Σ_σ Σ_{a<b} W=_ab x_aσ x_bσ + shift

with x = n - 1/2 in the half-filling form and x = n otherwise.

A sector (N↑, N↓) vector is an array X[d, u] over the N↓ and N↑
bit-strings (ascending integers), and H·X = D ⊙ X + K↓ X + X K↑ᵀ with the
sparse hop matrices K↑, K↓ and the diagonal D.  The ground state comes from
plain three-term Lanczos run twice (coefficients, then the Ritz vector),
restarted from its own Ritz vector until the explicit residual is small;
each Green's function component is a Lanczos continued fraction of
``ngfiter`` steps from c†|0> and c|0>: the diagonal injections, and for
each pair a < b the injections a + w·b (w = 1, and w = i where h is
complex), from which G_ab and G_ba follow.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from itertools import combinations
from math import comb
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclass
class Problem:
    """One impurity problem: the one-body matrices and the interaction."""
    h: np.ndarray             # [2, Ns, Ns] one-body matrix of each spin
    nimp: int                 # impurity levels: the first nimp
    w_updw: np.ndarray        # [nimp, nimp] W↑↓
    w_same: np.ndarray        # [nimp, nimp] W=, upper triangle used
    half_filling_form: bool
    shift: float
    beta: float
    lmats: int
    ngfiter: int

    @property
    def ns(self) -> int:
        return self.h.shape[1]

    @property
    def is_complex(self) -> bool:
        return bool(np.iscomplexobj(self.h) and np.any(self.h.imag != 0))

    @property
    def spin_symmetric(self) -> bool:
        """H is the same under ↑ <-> ↓ (then sector (a, b) and (b, a) have
        one spectrum, and G↓ = G↑)."""
        return bool(np.array_equal(self.h[0], self.h[1])
                    and np.array_equal(self.w_updw, self.w_updw.T))

    def matsubara(self) -> np.ndarray:
        return np.pi / self.beta * (2 * np.arange(self.lmats) + 1)


# ---------------------------------------------------------------------------
# one spin's Fock space
# ---------------------------------------------------------------------------

def bit_strings(ns: int, n: int) -> np.ndarray:
    """The bit-strings of ``n`` particles on ``ns`` levels, ascending."""
    if n < 0 or n > ns:
        return np.zeros(0, np.int64)
    out = np.fromiter((sum(1 << p for p in c)
                       for c in combinations(range(ns), n)),
                      dtype=np.int64, count=comb(ns, n))
    return np.sort(out)


def occupations(states: np.ndarray, levels: int) -> np.ndarray:
    """[dim, levels] 0/1 occupations of the first ``levels`` levels."""
    return ((states[:, None] >> np.arange(levels)[None, :]) & 1) \
        .astype(np.float64)


def _sign_below(states: np.ndarray, level: int) -> np.ndarray:
    """(-1)^(number of occupied levels below ``level``)."""
    below = states & ((np.int64(1) << level) - 1)
    count = np.zeros(states.shape, np.int64)
    while np.any(below):
        count += below & 1
        below = below >> 1
    return 1.0 - 2.0 * (count & 1)


def hop_matrix(states: np.ndarray, h: np.ndarray):
    """COO (rows, cols, vals) of Σ_{i≠j} h_ij c†_i c_j on one spin's
    ``states``."""
    rows, cols, vals = [], [], []
    ns = h.shape[0]
    for i in range(ns):
        for j in range(ns):
            if i == j or h[i, j] == 0.0:
                continue
            src = np.nonzero(((states >> j) & 1 == 1)
                             & ((states >> i) & 1 == 0))[0]
            m = states[src]
            s1 = _sign_below(m, j)
            m1 = m & ~(np.int64(1) << j)
            s2 = _sign_below(m1, i)
            dst = np.searchsorted(states, m1 | (np.int64(1) << i))
            rows.append(dst)
            cols.append(src)
            vals.append(h[i, j] * s1 * s2)
    if not rows:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, h.dtype),)
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def creation_map(src: np.ndarray, dst: np.ndarray, level: int, create: bool):
    """(source indices, destination indices, signs) of c†_level (or
    c_level) from the ``src`` strings into the ``dst`` strings."""
    occ = (src >> level) & 1 == 1
    sel = np.nonzero(~occ if create else occ)[0]
    m = src[sel]
    new = m | (np.int64(1) << level) if create else m & ~(np.int64(1) << level)
    return sel, np.searchsorted(dst, new), _sign_below(m, level)


# ---------------------------------------------------------------------------
# a sector on the device
# ---------------------------------------------------------------------------

def _csr(dim: int, coo, dtype, device) -> torch.Tensor:
    r, c, v = coo
    with warnings.catch_warnings():      # torch's note on sparse CSR
        warnings.simplefilter("ignore", UserWarning)
        t = torch.sparse_coo_tensor(
            torch.as_tensor(np.stack([r, c])), torch.as_tensor(v),
            (dim, dim)).coalesce()
        return t.to_sparse_csr().to(device=device, dtype=dtype)


def _spin_energy(problem: Problem, occ: np.ndarray, spin: int) -> np.ndarray:
    """Σ_a h_σ,aa n_a + Σ_{a<b} W=_ab x_a x_b of each string, with x the
    impurity occupations in the problem's form."""
    e = occ @ np.real(np.diag(problem.h[spin]))
    x = occ[:, :problem.nimp] - (0.5 if problem.half_filling_form else 0.0)
    w = np.triu(problem.w_same, 1)
    return e + np.einsum("sa,ab,sb->s", x, w, x)


class Sector:
    """H of one (N↑, N↓) sector as D, K↓, K↑ on ``device``."""

    def __init__(self, problem: Problem, nup: int, ndw: int, dtype, device):
        self.nup, self.ndw = nup, ndw
        ns, nimp = problem.ns, problem.nimp
        self.up = bit_strings(ns, nup)
        self.dw = bit_strings(ns, ndw)
        occ_up, occ_dw = occupations(self.up, ns), occupations(self.dw, ns)
        c = 0.5 if problem.half_filling_form else 0.0
        diag = _spin_energy(problem, occ_dw, 1)[:, None] \
            + _spin_energy(problem, occ_up, 0)[None, :] \
            + (occ_dw[:, :nimp] - c) @ problem.w_updw.T \
            @ (occ_up[:, :nimp] - c).T + problem.shift
        self.dtype, self.device = dtype, device
        real = dtype.to_real() if dtype.is_complex else dtype
        self.diag = torch.as_tensor(diag).to(device=device, dtype=real)
        self.k_up = _csr(len(self.up), hop_matrix(self.up, problem.h[0]),
                         dtype, device)
        self.k_dw = _csr(len(self.dw), hop_matrix(self.dw, problem.h[1]),
                         dtype, device)
        self.occ_up = torch.as_tensor(occ_up[:, :nimp]).to(device, real)
        self.occ_dw = torch.as_tensor(occ_dw[:, :nimp]).to(device, real)

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.dw), len(self.up)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """H·X for X [B, d, u] (a batch of sector vectors)."""
        nb, d, u = x.shape
        y = self.diag * x
        xd = x.permute(1, 0, 2).reshape(d, nb * u)
        y += torch.sparse.mm(self.k_dw, xd).reshape(d, nb, u) \
            .permute(1, 0, 2)
        del xd
        xu = x.permute(2, 0, 1).reshape(u, nb * d)
        y += torch.sparse.mm(self.k_up, xu).reshape(u, nb, d) \
            .permute(1, 2, 0)
        return y


# ---------------------------------------------------------------------------
# Lanczos
# ---------------------------------------------------------------------------

def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise real parts of <a|b> of [B, ...] tensors, accumulated in
    the tensors' own type."""
    return (a.conj() * b).flatten(1).sum(1).real


def _tridiag(alphas, betas) -> Tuple[np.ndarray, np.ndarray]:
    """Eigenvalues and eigenvectors of the Lanczos matrix."""
    k = len(alphas)
    t = np.diag(np.asarray(alphas, np.float64))
    if k > 1:
        b = np.asarray(betas[:k - 1], np.float64)
        t += np.diag(b, 1) + np.diag(b, -1)
    return np.linalg.eigh(t)


def _lanczos_pass(sector: Sector, q0: torch.Tensor, steps: int,
                  coeffs=None, tol: float = 0.0):
    """Three-term Lanczos from the unit vector ``q0`` [1, d, u].  Without
    ``coeffs``: returns (alphas, betas) after at most ``steps`` steps,
    stopped once the lowest Ritz value's residual estimate is under
    ``tol``·max(1, |θ|).  With ``coeffs`` (the Ritz vector's coefficients):
    retraces the same recurrence and returns Σ_k coeffs[k] q_k."""
    alphas, betas = [], []
    acc = None if coeffs is None else coeffs[0] * q0
    q_prev, q, beta = torch.zeros_like(q0), q0, 0.0
    n = steps if coeffs is None else len(coeffs)
    for k in range(n):
        w = sector.apply(q)
        alpha = float(_dot(q, w)[0])
        w -= alpha * q + beta * q_prev
        alphas.append(alpha)
        beta = float(torch.linalg.vector_norm(w))
        if coeffs is not None:
            if k + 1 < n:
                q_prev, q = q, w / beta
                acc += coeffs[k + 1] * q
            continue
        betas.append(beta)
        if beta < 1e-12 * max(1.0, abs(alpha)):
            break
        if (k + 1) % 5 == 0 or k + 1 == steps:
            vals, vecs = _tridiag(alphas, betas)
            if abs(beta * vecs[-1, 0]) <= tol * max(1.0, abs(vals[0])):
                break
        q_prev, q = q, w / beta
    return (alphas, betas) if coeffs is None else acc


@dataclass
class GroundState:
    energy: float
    vector: torch.Tensor      # [d, u], unit norm
    residual: float           # |H x - E x| / max(1, |E|)


def _start(sector: Sector, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((1,) + sector.shape, generator=g, dtype=torch.float64)
    return x.to(device=sector.device, dtype=sector.dtype)


def ground_state(sector: Sector, seed: int, tol: float, steps: int = 400,
                 cycles: int = 6) -> GroundState:
    """The lowest eigenpair of ``sector``: Lanczos to the residual
    estimate ``tol``, the Ritz vector by a second pass, then restarts from
    the Ritz vector until its explicit residual is under 10·tol (or
    ``cycles`` runs)."""
    x = _start(sector, seed)
    best = None
    for _ in range(cycles):
        x = x / torch.linalg.vector_norm(x)
        alphas, betas = _lanczos_pass(sector, x, steps, tol=tol)
        vals, vecs = _tridiag(alphas, betas)
        x = _lanczos_pass(sector, x, steps, coeffs=vecs[:, 0])
        x = x / torch.linalg.vector_norm(x)
        hx = sector.apply(x)
        energy = float(_dot(x, hx)[0])
        resid = float(torch.linalg.vector_norm(hx - energy * x)) \
            / max(1.0, abs(energy))
        del hx
        if best is None or resid < best.residual:
            best = GroundState(energy, x[0], resid)
        if resid <= 10 * tol:
            break
    return best


def lowest_energy(sector: Sector, seed: int, tol: float,
                  steps: int = 400) -> float:
    """The lowest Ritz value of one Lanczos run (energies of the
    neighbouring sectors)."""
    x = _start(sector, seed)
    x = x / torch.linalg.vector_norm(x)
    alphas, betas = _lanczos_pass(sector, x, steps, tol=tol)
    return float(_tridiag(alphas, betas)[0][0])


def chain_resolvent(sector: Sector, phi: torch.Tensor, steps: int,
                    shift: float, sign: int, z: np.ndarray) -> np.ndarray:
    """<φ| (z - sign·(H - shift))^{-1} |φ> for each row φ of ``phi``
    [B, d, u] by a ``steps``-step Lanczos continued fraction (a row whose
    Krylov space closes stops there).  Returns [B, len(z)] complex."""
    nb = phi.shape[0]
    norm = torch.linalg.vector_norm(phi.flatten(1), dim=1)
    q = phi / norm.clamp_min(1e-300)[:, None, None]
    q_prev = torch.zeros_like(q)
    beta = torch.zeros(nb, dtype=norm.dtype, device=phi.device)
    alphas, betas = [], []
    for _ in range(steps):
        w = sector.apply(q)
        alpha = _dot(q, w)
        w -= alpha[:, None, None] * q + beta[:, None, None] * q_prev
        beta = torch.linalg.vector_norm(w.flatten(1), dim=1)
        alphas.append(alpha.double().cpu().numpy())
        betas.append(beta.double().cpu().numpy())
        q_prev, q = q, w / beta.clamp_min(1e-300)[:, None, None]
    alphas, betas = np.array(alphas).T, np.array(betas).T
    norm2 = (norm.double().cpu().numpy()) ** 2
    out = np.zeros((nb, len(z)), np.complex128)
    for i in range(nb):
        a, b = alphas[i], betas[i]
        floor = 1e-10 * max(1.0, np.abs(a).max())
        closed = np.nonzero(b[:-1] < floor)[0]
        k = closed[0] + 1 if len(closed) else len(a)
        vals, vecs = _tridiag(a[:k], b[:k])
        poles = sign * (vals - shift)
        out[i] = norm2[i] * np.sum(vecs[0] ** 2 / (z[:, None] - poles),
                                   axis=1)
    return out


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

@dataclass
class Solution:
    sectors: List[Tuple[int, int]]    # the sectors at the lowest energy
    energies: Dict[Tuple[int, int], float]
    egs: float
    residual: float
    g: np.ndarray                     # [2, nimp, nimp, lmats] per spin
    sigma: np.ndarray                 # [2, nimp, nimp, lmats]
    dens: np.ndarray                  # [nimp] n↑ + n↓
    docc: np.ndarray                  # [nimp] <n↑ n↓>


def _excite(x: torch.Tensor, src: Sector, dst: Sector, level: int,
            spin: int, create: bool) -> torch.Tensor:
    """c†_level,spin |x> (or c) from sector ``src`` into ``dst``; the
    sign of the other spin's strings is the same for every state of a
    sector and drops out of every G that is diagonal in spin."""
    s, t, sgn = creation_map(src.dw if spin else src.up,
                             dst.dw if spin else dst.up, level, create)
    out = torch.zeros(dst.shape, dtype=x.dtype, device=x.device)
    dev = x.device
    s, t = torch.as_tensor(s, device=dev), torch.as_tensor(t, device=dev)
    sgn = torch.as_tensor(sgn, device=dev, dtype=x.dtype)
    if spin:
        out[t, :] = x[s, :] * sgn[:, None]
    else:
        out[:, t] = x[:, s] * sgn
    return out


def _green(problem: Problem, sec: Sector, gs: GroundState, spin: int,
           dtype, device, batch: int, z: np.ndarray) -> np.ndarray:
    """[nimp, nimp, len(z)] G of one spin from c† and c chains."""
    nimp, x = problem.nimp, gs.vector
    weights = (1.0, 1j) if problem.is_complex else (1.0,)
    inj = [(a, a, 1.0) for a in range(nimp)] + \
        [(a, b, w) for a in range(nimp) for b in range(a + 1, nimp)
         for w in weights]
    g_inj = np.zeros((len(inj), len(z)), np.complex128)
    for create, dn in ((True, 1), (False, -1)):
        n = (sec.ndw if spin else sec.nup) + dn
        if not 0 <= n <= problem.ns:
            continue
        nup, ndw = (sec.nup, n) if spin else (n, sec.ndw)
        dst = Sector(problem, nup, ndw, dtype, device)
        base = [_excite(x, sec, dst, a, spin, create) for a in range(nimp)]
        step = batch or len(inj)
        for lo in range(0, len(inj), step):
            chunk = inj[lo:lo + step]
            # c†_a + w c†_b and c_a + w* c_b: both give
            # G_aa + G_bb + w G_ab + w* G_ba
            phi = torch.stack([
                base[a] if a == b else
                base[a] + (w if create else w.conjugate()) * base[b]
                for a, b, w in chunk])
            g_inj[lo:lo + len(chunk)] += chain_resolvent(
                dst, phi, problem.ngfiter, gs.energy, 1 if create else -1, z)
            del phi
        del base, dst
    gm = np.zeros((nimp, nimp, len(z)), np.complex128)
    for (a, b, _), g in zip(inj, g_inj):
        if a == b:
            gm[a, a] = g
    mixed = {}
    for (a, b, w), g in zip(inj, g_inj):
        if a != b:
            mixed[(a, b, w)] = g - gm[a, a] - gm[b, b]
    for a in range(nimp):
        for b in range(a + 1, nimp):
            s = mixed[(a, b, 1.0)]                       # G_ab + G_ba
            d = -1j * mixed[(a, b, 1j)] if problem.is_complex else 0.0
            gm[a, b], gm[b, a] = 0.5 * (s + d), 0.5 * (s - d)
    return gm


def solve(problem: Problem, sectors: List[Tuple[int, int]], dtype=torch.float64,
          device="cpu", seed: int = 1, degenerate: float = 1e-7,
          batch: int = 0) -> Solution:
    """Ground state over ``sectors``, then G, Sigma and the observables of
    the lowest one.  ``dtype`` float32 is the lower-precision control (a
    complex problem runs in the complex type of that precision).
    ``batch`` caps the injections run together (0: all of one target
    sector at once)."""
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    if problem.is_complex:
        dtype = dtype.to_complex()
    energies = {}
    for nup, ndw in sectors:
        if (nup, ndw) in energies:
            continue
        sec = Sector(problem, nup, ndw, dtype, device)
        energies[(nup, ndw)] = lowest_energy(sec, seed, tol)
        if problem.spin_symmetric and (ndw, nup) in sectors:
            energies[(ndw, nup)] = energies[(nup, ndw)]
        del sec
    emin = min(energies.values())
    low = sorted(k for k, e in energies.items()
                 if e - emin <= degenerate * max(1.0, abs(emin)))
    nup, ndw = min(low, key=lambda k: energies[k])
    sec = Sector(problem, nup, ndw, dtype, device)
    gs = ground_state(sec, seed, tol)
    x = gs.vector

    # observables: n↑ + n↓ and n↑ n↓ on each impurity level
    prob = (x.conj() * x).real
    n_up = (prob.sum(0) @ sec.occ_up)
    n_dw = (prob.sum(1) @ sec.occ_dw)
    docc = ((sec.occ_dw.T @ prob) * sec.occ_up.T).sum(1)
    dens = (n_up + n_dw).double().cpu().numpy()
    docc = docc.double().cpu().numpy()

    z = 1j * problem.matsubara()
    g = np.zeros((2, problem.nimp, problem.nimp, len(z)), np.complex128)
    g[0] = _green(problem, sec, gs, 0, dtype, device, batch, z)
    g[1] = g[0] if problem.spin_symmetric else \
        _green(problem, sec, gs, 1, dtype, device, batch, z)

    # Sigma = G0^-1 - G^-1, G0 the impurity block of (z - h_σ)^-1
    eye = np.eye(problem.ns)
    sigma = np.zeros_like(g)
    for s in range(2):
        g0 = np.linalg.inv(z[:, None, None] * eye - problem.h[s][None])
        g0 = g0[:, :problem.nimp, :problem.nimp]
        sm = np.linalg.inv(g0) - np.linalg.inv(np.moveaxis(g[s], -1, 0))
        sigma[s] = np.moveaxis(sm, 0, -1)
    return Solution(sectors=low, energies=energies, egs=gs.energy,
                    residual=gs.residual, g=g, sigma=sigma, dens=dens,
                    docc=docc)
