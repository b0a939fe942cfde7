"""Fock-space combinatorics for the (N_up, N_dw)-conserving cluster problem.

Host-side copy of the JAX package's ``utils/fock.py`` (numpy paths only):
all sector bookkeeping is done **vectorised on host in NumPy** and produces
integer tables that are shipped to the device once per sector.
Conventions match the reference exactly:

* Per-spin levels ``Ns = Nimp*(Nbath+1)``; bit ``b`` of a spin bit-string is
  level ``b+1`` in the reference's 1-based labelling.  Impurity levels occupy
  bits ``0..Nimp-1``; bath replica ``k`` (0-based) occupies bits
  ``Nimp*(k+1)..Nimp*(k+2)-1`` (ED_SETUP.f90:367-375 getBathStride).
* A sector is labelled by ``(nup, ndw)``; its 1-based index is
  ``isector = 1 + ndw + nup*(Ns+1)`` (ED_SETUP.f90:446-457).
* A sector state is ``|up>|dw>`` with the flat index ``i = iup + idw*DimUp``
  (0-based; ED_SETUP.f90:547-560).  We therefore store sector vectors as 2-D
  arrays ``v[DimDw, DimUp]`` whose C-order flattening reproduces the
  reference layout bit-for-bit.
* Fermionic sign of ``c_b``/``c^+_b`` on a bit-string ``m`` is the parity of
  the set bits strictly below ``b`` (ED_SETUP.f90:807-833); up and dw strings
  carry independent Jordan-Wigner phases (consistent with the reference's
  factorised |up>⊗|dw> convention used in H-build, GF and observables).
"""
from __future__ import annotations

from functools import lru_cache
from math import comb
from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# bit utilities (vectorised)
# ---------------------------------------------------------------------------

def popcount(x: np.ndarray) -> np.ndarray:
    """Vectorised population count (numpy>=2 bitwise_count, else a
    byte-table sum)."""
    x = np.asarray(x, dtype=np.uint64)
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x).astype(np.int64)
    table = np.array([bin(i).count("1") for i in range(256)], np.int64)
    return table[x.view(np.uint8).reshape(x.shape + (8,))].sum(axis=-1)


def parity_below(m: np.ndarray, b) -> np.ndarray:
    """(-1)^{#set bits of m strictly below bit b} as ±1 int8.

    This is the fermionic string sign of applying c_b / c^+_b to |m>
    (reference sign convention, ED_SETUP.f90:807-833).
    """
    m = np.asarray(m, dtype=np.int64)
    mask = (np.int64(1) << np.int64(b)) - 1
    cnt = popcount(m & mask)
    return np.where(cnt & 1 == 1, -1, 1).astype(np.int8)


def bdecomp(states: np.ndarray, ntot: int) -> np.ndarray:
    """Binary decomposition: [N] -> [N, ntot] of 0/1 (ED_SETUP.f90:935-945)."""
    states = np.asarray(states, dtype=np.int64).reshape(-1, 1)
    bits = np.arange(ntot, dtype=np.int64).reshape(1, -1)
    return ((states >> bits) & 1).astype(np.int8)


def bjoin(bits: np.ndarray) -> np.ndarray:
    """Inverse of bdecomp: [..., ntot] 0/1 -> integer states."""
    bits = np.asarray(bits, dtype=np.int64)
    w = np.int64(1) << np.arange(bits.shape[-1], dtype=np.int64)
    return (bits * w).sum(axis=-1)


# ---------------------------------------------------------------------------
# sector codecs (reference: ED_SETUP.f90:446-520)
# ---------------------------------------------------------------------------

def get_sector(nup: int, ndw: int, ns: int) -> int:
    """1-based sector index from quantum numbers (ED_SETUP.f90:446-457)."""
    return 1 + ndw + nup * (ns + 1)


def get_quantum_numbers(isector: int, ns: int) -> Tuple[int, int]:
    """(nup, ndw) from 1-based sector index (ED_SETUP.f90:477-500)."""
    count = isector - 1
    ndw = count % (ns + 1)
    nup = count // (ns + 1)
    return nup, ndw


def get_sector_dim(isector: int, ns: int) -> int:
    nup, ndw = get_quantum_numbers(isector, ns)
    return comb(ns, nup) * comb(ns, ndw)


def get_twin_sector(isector: int, ns: int) -> int:
    """Sector with (nup,ndw) -> (ndw,nup) (ED_SETUP.f90:906-913)."""
    nup, ndw = get_quantum_numbers(isector, ns)
    return get_sector(ndw, nup, ns)


def all_sectors(ns: int):
    """Iterate 1-based sector indices in reference order."""
    return range(1, (ns + 1) ** 2 + 1)


# ---------------------------------------------------------------------------
# sector state maps
# ---------------------------------------------------------------------------

@lru_cache(maxsize=4096)
def sector_states(ns: int, n: int) -> np.ndarray:
    """Sorted bit-states of ns levels with exactly n particles.

    Matches the reference map ordering (increasing integer value,
    ED_SETUP.f90:748-773).  Uses direct enumeration for small ns and
    colex-ordered combinadic generation for large ns so the cost is
    O(dim) rather than O(2^ns).
    """
    if n < 0 or n > ns:
        return np.zeros(0, dtype=np.int64)
    if n == 0:
        return np.zeros(1, dtype=np.int64)
    if ns <= 22:
        allstates = np.arange(1 << ns, dtype=np.int64)
        return allstates[popcount(allstates) == n]
    # combinadic: states with n bits in increasing numeric order are exactly
    # combinations ordered colexicographically by their bit positions
    dim = comb(ns, n)
    out = np.empty(dim, dtype=np.int64)
    pos = list(range(n))  # bit positions, ascending
    for i in range(dim):
        s = 0
        for p in pos:
            s |= 1 << p
        out[i] = s
        # next colex combination
        j = 0
        while j + 1 < n and pos[j] + 1 == pos[j + 1]:
            pos[j] = j
            j += 1
        pos[j] += 1
    return out


def state_index(sorted_states: np.ndarray, states: np.ndarray) -> np.ndarray:
    """Index of each state in the sorted sector map (binary search)."""
    return np.searchsorted(sorted_states, states)


# ---------------------------------------------------------------------------
# level layout (reference: ED_SETUP.f90:367-375,563-568)
# ---------------------------------------------------------------------------

def imp_level(ilat: int, iorb: int, norb: int) -> int:
    """0-based level of impurity orbital (ilat,iorb), both 0-based."""
    return iorb + ilat * norb


def bath_level(ilat: int, iorb: int, ibath: int, nlat: int, norb: int) -> int:
    """0-based level of bath replica ibath's orbital (ilat,iorb)."""
    return nlat * norb * (1 + ibath) + iorb + ilat * norb


# ---------------------------------------------------------------------------
# one-body operator application on a sector map (vectorised c^+_a c_b)
# ---------------------------------------------------------------------------

def hop_entries(states: np.ndarray, a: int, b: int):
    """All matrix elements of c^+_a c_b (a != b) within one spin sector map.

    Returns (rows, cols, signs): for each source state ``states[col]`` with
    bit b set and bit a clear, the target row index in the same map and the
    fermionic sign s1*s2 (reference loop bodies, e.g.
    ED_HAMILTONIAN/sparse/H_up.f90:8-28).
    """
    m = states
    sel = ((m >> b) & 1 == 1) & ((m >> a) & 1 == 0)
    cols = np.nonzero(sel)[0]
    ms = m[cols]
    s1 = parity_below(ms, b)
    k1 = ms & ~(np.int64(1) << b)
    s2 = parity_below(k1, a)
    k2 = k1 | (np.int64(1) << a)
    rows = np.searchsorted(m, k2)
    return rows, cols, (s1.astype(np.int64) * s2.astype(np.int64))


def number_op(states: np.ndarray, levels: np.ndarray) -> np.ndarray:
    """Occupations n_l for each state: [dim, len(levels)] of 0/1 (float64)."""
    m = np.asarray(states, dtype=np.int64).reshape(-1, 1)
    lv = np.asarray(levels, dtype=np.int64).reshape(1, -1)
    return ((m >> lv) & 1).astype(np.float64)


def op_map(states_src: np.ndarray, states_dst: np.ndarray, level: int,
           create: bool):
    """Single-operator map between sector maps: c^+_level or c_level.

    Returns (tgt, sgn): for each source index j, the destination index in
    ``states_dst`` (or -1 if annihilated) and the fermionic sign.  Used for
    GF excitation injection (ED_GF_NORMAL.f90:174-199) and the sp-density
    matrix.
    """
    m = states_src
    occupied = ((m >> level) & 1).astype(bool)
    sel = ~occupied if create else occupied
    sgn = parity_below(m, level).astype(np.int64)
    bit = np.int64(1) << level
    new = np.where(sel, m | bit if create else m & ~bit, -1)
    tgt = np.full(m.shape, -1, dtype=np.int64)
    idx = np.nonzero(sel)[0]
    tgt[idx] = np.searchsorted(states_dst, new[idx])
    sgn = np.where(sel, sgn, 0)
    return tgt, sgn


# ---------------------------------------------------------------------------
# twin-sector reordering (reference: ED_SETUP.f90:854-898)
# ---------------------------------------------------------------------------

def twin_sector_order(ns: int, nup: int, ndw: int) -> np.ndarray:
    """Ordering that maps sector (nup,ndw) eigenvectors onto the twin
    (ndw,nup) basis.

    Reference algorithm (ED_SETUP.f90:854-878): for each state of sector A
    compute the flipped full-space state |dw>|up>, then argsort.  The i-th
    twin-sector amplitude is ``v[order[i]]``.
    """
    up = sector_states(ns, nup)
    dw = sector_states(ns, ndw)
    dim_up, dim_dw = len(up), len(dw)
    # flat index i = iup + idw*DimUp; flipped state value = dw + up*2^ns
    flip = (dw.reshape(-1, 1) + (up.reshape(1, -1) << np.int64(ns))).ravel()
    return np.argsort(flip, kind="stable")
