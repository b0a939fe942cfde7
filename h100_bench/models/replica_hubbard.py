"""The program side of the one-band Hubbard cluster with replica baths
(``"model": "replica_hubbard"``): the bath of each solve, the program's
solver for it, and what the program is handed.  Its reference side is
``reference/replica_hubbard.py``.

A model module has ``draw_bath(config, draw)``, ``make_solver(config,
settings, work_dir, device, ref)``, ``hloc(config, ref)`` and
``bath_array(config, bath)``, where ``ref`` is the model's reference side
as the harness loaded it; only ``make_solver`` touches the program, and it
imports it inside.

The bath: the configuration's published one, {"levels": [λ_b], "v":
[v_b]}, with each level and hybridisation scaled by a factor of ``draw``.
Replicas whose levels mirror each other about 0 form one group and share
their two factors, so a particle-hole symmetric bath stays symmetric and
the half-filled sector stays the ground state.
"""
from __future__ import annotations

from typing import List

import numpy as np


def mirror_groups(levels) -> List[List[int]]:
    """Replica indices grouped by |level| (mirror pairs and a level 0)."""
    groups: dict = {}
    for i, lev in enumerate(levels):
        groups.setdefault(round(abs(float(lev)), 12), []).append(i)
    return [groups[k] for k in sorted(groups)]


def draw_bath(config: dict, draw) -> dict:
    """The bath of one solve; ``draw(shape)`` gives factors near 1."""
    levels = np.asarray(config["bath"]["levels"], np.float64)
    v = np.asarray(config["bath"]["v"], np.float64)
    groups = mirror_groups(levels)
    f = draw((len(groups), 2))
    for g, (fl, fv) in zip(groups, f):
        levels[g] *= fl
        v[g] *= fv
    return {"levels": levels.tolist(), "v": v.tolist()}


def hloc(config: dict, ref) -> np.ndarray:
    """The cluster hopping as the solver's [Nlat, Nlat, Nspin, Nspin,
    Norb, Norb] Hloc (one spin, one orbital)."""
    h = ref.cluster_hopping(config["cluster"])
    return h.astype(np.complex128)[:, :, None, None, None, None]


def bath_array(config: dict, bath: dict) -> np.ndarray:
    """The flat bath array of a replica bath with one symmetry (identity)
    per replica, in the reference code's layout (dmft_aux.f90
    get_dmft_bath): Nsym for every replica, then each replica's v and
    lambda."""
    levels, v = bath["levels"], bath["v"]
    return np.concatenate([np.ones(len(levels))]
                          + [np.array([v[b], levels[b]])
                             for b in range(len(levels))])


def make_solver(config: dict, settings: dict, work_dir: str, device, ref):
    """The program's solver, its replica basis the identity on the
    cluster."""
    from cdmft_lanc_ed_torch import EDConfig, EDSolver
    cfg = EDConfig(**settings, work_dir=work_dir)
    solver = EDSolver(cfg, device=device)
    nlat = cfg.nlat
    basis = np.zeros((1, nlat, nlat, 1, 1, 1, 1), np.complex128)
    basis[0, np.arange(nlat), np.arange(nlat)] = 1.0
    solver.set_hbath(basis, np.asarray(config["bath"]["levels"])[:, None])
    solver.init_solver()
    return solver
