"""The program side of the BHZ chain cluster with general baths
(``"model": "bhz_general"``); its reference side is
``reference/bhz_general.py``.  The bath: the configuration's published
one, {"lambda": [[...]], "v": [[...]]}, each replica's lambdas and its
hybridisations scaled by factors of ``draw``."""
from __future__ import annotations

import numpy as np


def draw_bath(config: dict, draw) -> dict:
    lam = np.asarray(config["bath"]["lambda"], np.float64)
    v = np.asarray(config["bath"]["v"], np.float64)
    f = draw((len(lam), lam.shape[1] + 1))
    return {"lambda": (lam * f[:, :-1]).tolist(),
            "v": (v * f[:, -1:]).tolist()}


def hloc(config: dict, ref) -> np.ndarray:
    cl = config["cluster"]
    return ref.cluster(cl["nx"], cl["mh"], cl["ts"], cl["lam"])


def bath_array(config: dict, bath: dict) -> np.ndarray:
    """The general bath's flat array (dmft_aux.f90 get_dmft_bath): Nsym
    for every replica, then each replica's v over lso and its lambdas."""
    lam, v = bath["lambda"], bath["v"]
    return np.concatenate([np.full(len(lam), float(len(lam[0])))]
                          + [np.concatenate([v[b], lam[b]])
                             for b in range(len(lam))])


def make_solver(config: dict, settings: dict, work_dir: str, device, ref):
    from cdmft_lanc_ed_torch import EDConfig, EDSolver
    cfg = EDConfig(**settings, work_dir=work_dir)
    solver = EDSolver(cfg, device=device)
    solver.set_hbath(ref.basis(config["cluster"]["nx"]),
                     np.asarray(config["bath"]["lambda"]))
    solver.init_solver()
    return solver
