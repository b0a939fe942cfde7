"""The program side of the BHZ chain cluster with general baths
(``"model": "bhz_chain"``): the bath of each solve, the program's solver
for it, and what the program is handed.  Its reference side is
``reference/bhz_chain.py``; see ``replica_hubbard.py`` for what a model
module holds.

The bath: the configuration's published one, {"lambda": [[mh_b, ts_b,
lam_b]], "v": [[v_b,lso]]}, with each bath's three lambdas and its row of
hybridisations scaled by four factors of ``draw``.
"""
from __future__ import annotations

import numpy as np


def draw_bath(config: dict, draw) -> dict:
    """The bath of one solve; ``draw(shape)`` gives factors near 1."""
    lam = np.asarray(config["bath"]["lambda"], np.float64)
    v = np.asarray(config["bath"]["v"], np.float64)
    f = draw((len(lam), lam.shape[1] + 1))
    return {"lambda": (lam * f[:, :-1]).tolist(),
            "v": (v * f[:, -1:]).tolist()}


def hloc(config: dict, ref) -> np.ndarray:
    """The cluster's [Nlat, Nlat, Nspin, Nspin, Norb, Norb] Hloc."""
    cl = config["cluster"]
    return ref.cluster(cl["nx"], cl["mh"], cl["ts"], cl["lam"])


def bath_array(config: dict, bath: dict) -> np.ndarray:
    """The general bath's flat array in the reference code's layout
    (dmft_aux.f90 get_dmft_bath): Nsym for every bath, then each bath's v
    over lso and its lambdas."""
    lam, v = bath["lambda"], bath["v"]
    return np.concatenate([np.full(len(lam), float(len(lam[0])))]
                          + [np.concatenate([v[b], lam[b]])
                             for b in range(len(lam))])


def make_solver(config: dict, settings: dict, work_dir: str, device, ref):
    """The program's solver, its bath basis the unit-amplitude BHZ
    matrices."""
    from cdmft_lanc_ed_torch import EDConfig, EDSolver
    cfg = EDConfig(**settings, work_dir=work_dir)
    solver = EDSolver(cfg, device=device)
    solver.set_hbath(ref.basis(config["cluster"]["nx"]),
                     np.asarray(config["bath"]["lambda"]))
    solver.init_solver()
    return solver
