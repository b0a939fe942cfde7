"""SSH (Su-Schrieffer-Heeger) dimerised chain, Ndimer-dimer cluster.

Copy of the JAX package's ``models/ssh.py``; counterpart of the
reference's drivers/cdn_ssh.f90 (Nlat = 2*Ndimer):
alternating hoppings t*(1+delta) (intra-dimer) and t*(1-delta)
(inter-dimer); the cluster holds Ndimer dimers, the superlattice is 1d
with period 2*Ndimer sites.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..utils.reshape import nnn2lso


def ssh_cluster_hloc(ndimer: int, t: float, delta: float,
                     nspin: int = 1) -> np.ndarray:
    nlat = 2 * ndimer
    h = np.zeros((nlat, nlat, nspin, nspin, 1, 1), np.complex128)
    t_in = -t * (1.0 + delta)
    t_out = -t * (1.0 - delta)
    for s in range(nspin):
        for i in range(nlat - 1):
            amp = t_in if i % 2 == 0 else t_out
            h[i, i + 1, s, s, 0, 0] = amp
            h[i + 1, i, s, s, 0, 0] = amp
    return h


def ssh_cluster_hk(ndimer: int, nk: int, t: float, delta: float,
                   nspin: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    nlat = 2 * ndimer
    hloc = ssh_cluster_hloc(ndimer, t, delta, nspin)
    t_out = -t * (1.0 - delta)
    ks = 2.0 * np.pi * np.arange(nk) / nk
    hks = []
    for k in ks:
        h = np.array(hloc)
        for s in range(nspin):
            ph = np.exp(1j * k)       # phase over one supercell
            h[nlat - 1, 0, s, s, 0, 0] += t_out * ph
            h[0, nlat - 1, s, s, 0, 0] += t_out * np.conj(ph)
        hks.append(nnn2lso(h, nlat, nspin, 1))
    return np.stack(hks), hloc
