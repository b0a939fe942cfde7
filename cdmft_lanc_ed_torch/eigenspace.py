"""Sorted eigenstate list with capacity constraint and twin reconstruction.

Port of the JAX package's ``eigenspace.py`` (itself replacing the
reference linked-list ``sparse_espace``, ED_EIGENSPACE.f90).  States keep
their sector label and the eigenvector in the reference flat layout
``i = iup + idw*DimUp``: a host array for dense-factor sectors, a tensor
left on the card for large sectors (the JAX package's device arrays and
``SplitVector`` planes, eigenspace.py:22-60; the port's complex vectors
are complex tensors).  Twin states (ed_twin) are pointer entries whose
vector is rebuilt on demand by the spin-flip reordering
(ED_EIGENSPACE.f90:464-496; ED_SETUP.f90:854-878).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .utils import fock


@dataclass
class EigenState:
    energy: float
    isector: int
    vector: object          # np.ndarray or torch.Tensor; None for twins
    itwin: bool = False
    twin_of: Optional["EigenState"] = None

    def get_vector(self, ns: int) -> np.ndarray:
        """Eigenvector in this state's own sector basis."""
        if not self.itwin:
            return self.vector
        src = self.twin_of
        nup, ndw = fock.get_quantum_numbers(src.isector, ns)
        order = fock.twin_sector_order(ns, nup, ndw)
        if isinstance(src.vector, torch.Tensor):
            return src.vector[torch.as_tensor(order,
                                              device=src.vector.device)]
        return src.vector[order]


class StateList:
    """Energy-ordered list with optional max size (es_add_state semantics,
    ED_EIGENSPACE.f90:197-220)."""

    def __init__(self):
        self.states: List[EigenState] = []

    # -- basic queries ---------------------------------------------------
    @property
    def size(self) -> int:
        return len(self.states)

    @property
    def emin(self) -> float:
        return self.states[0].energy if self.states else np.inf

    @property
    def emax(self) -> float:
        return self.states[-1].energy if self.states else -np.inf

    def __iter__(self):
        return iter(self.states)

    def __getitem__(self, i):
        return self.states[i]

    def gs_degeneracy(self, threshold: float) -> int:
        return sum(1 for s in self.states
                   if abs(s.energy - self.emin) < threshold)

    # -- mutation ---------------------------------------------------------
    def free(self):
        self.states.clear()

    def pop(self, n: Optional[int] = None):
        """Remove the n-th (default last) state; twins removed as pairs
        (ED_EIGENSPACE.f90:290-362)."""
        idx = (len(self.states) - 1) if n is None else n
        st = self.states[idx]
        partner = st.twin_of
        self.states.pop(idx)
        if partner is not None:
            try:
                self.states.remove(partner)
            except ValueError:
                pass

    def insert(self, energy: float, vector: np.ndarray, isector: int,
               ns: int, twin: bool = False):
        keys = [s.energy for s in self.states]
        pos = bisect.bisect_right(keys, energy)
        if not isinstance(vector, torch.Tensor):     # device vectors stay
            vector = np.asarray(vector)
        st = EigenState(energy, isector, vector)
        self.states.insert(pos, st)
        if twin:
            tw = EigenState(energy, fock.get_twin_sector(isector, ns),
                            None, itwin=True, twin_of=st)
            st.twin_of = tw
            self.states.insert(pos + 1, tw)

    def add(self, energy: float, vector: np.ndarray, isector: int, ns: int,
            twin: bool = False, size: Optional[int] = None):
        # A twin insertion occupies TWO slots (state + pointer entry); evict
        # pair-aware until both fit, like the reference handles twin pairs
        # atomically (ED_EIGENSPACE.f90:197-220, es_pop_state pair removal).
        if size is not None:
            need = 2 if twin else 1
            while self.size + need > size:
                if energy >= self.emax:
                    return
                self.pop()
        self.insert(energy, vector, isector, ns, twin=twin)

    # -- persistence (state_list.ed / .restart format) --------------------
    def save(self, path: str, ns: int):
        with open(path, "w") as fh:
            for i, s in enumerate(self.states):
                nup, ndw = fock.get_quantum_numbers(s.isector, ns)
                fh.write(f"{i+1:6d} {s.isector:6d} {nup:4d} {ndw:4d} "
                         f"{s.energy:25.15f}\n")
