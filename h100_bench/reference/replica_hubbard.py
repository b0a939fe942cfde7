"""The reference side of the one-band Hubbard cluster with replica baths
(``"model": "replica_hubbard"``): the plain problem of one solve.

Configuration keys read: ``cluster`` {nx, ny, t} (an open nx x ny cluster,
site ix + iy·nx, hopping -t between nearest neighbours), ``ed`` {uloc,
xmu, beta, lmats, lanc_ngfiter, hfmode} and the bath of the solve
{"levels": [λ_b], "v": [v_b]}: replica b copies every site i at level λ_b
(identity basis) and hybridises it with site i by v_b.

Levels: the nlat impurity sites first, then replica b's copy of site i at
nlat·(b+1) + i.  The interaction is U on each site, in the half-filling
form U (n↑ - 1/2)(n↓ - 1/2) unless ``hfmode`` is false.
"""
from __future__ import annotations

import numpy as np

from reference.cluster_ed import Problem


def cluster_hopping(cluster: dict) -> np.ndarray:
    """[nlat, nlat] hopping -t between nearest neighbours of an open
    nx x ny cluster, site = ix + iy·nx."""
    nx, ny, t = cluster["nx"], cluster["ny"], cluster["t"]
    h = np.zeros((nx * ny, nx * ny))
    for iy in range(ny):
        for ix in range(nx):
            i = ix + iy * nx
            if ix + 1 < nx:
                h[i, i + 1] = h[i + 1, i] = -t
            if iy + 1 < ny:
                h[i, i + nx] = h[i + nx, i] = -t
    return h


def one_body(hloc: np.ndarray, levels, v, xmu: float) -> np.ndarray:
    """[Ns, Ns] one-body matrix of one spin: the cluster, its replicas
    and their hybridisations, -xmu on the impurity sites."""
    nlat = hloc.shape[0]
    ns = nlat * (len(levels) + 1)
    h = np.zeros((ns, ns))
    h[:nlat, :nlat] = hloc
    h[np.arange(nlat), np.arange(nlat)] -= xmu
    for b, (lev, vb) in enumerate(zip(levels, v)):
        copy = nlat * (b + 1) + np.arange(nlat)
        h[copy, copy] = lev
        h[copy, np.arange(nlat)] = vb
        h[np.arange(nlat), copy] = vb
    return h


def problem_of(hloc: np.ndarray, levels, v, u: float, xmu: float,
               beta: float, lmats: int, ngfiter: int,
               half_filling_form: bool = True) -> Problem:
    nlat = hloc.shape[0]
    h = one_body(hloc, np.asarray(levels, float), np.asarray(v, float), xmu)
    return Problem(h=np.stack([h, h]), nimp=nlat,
                   w_updw=u * np.eye(nlat), w_same=np.zeros((nlat, nlat)),
                   half_filling_form=half_filling_form, shift=0.0,
                   beta=beta, lmats=lmats, ngfiter=ngfiter)


def problem(config: dict, bath: dict) -> Problem:
    """The plain problem of the solve at ``bath``."""
    ed = config["ed"]
    return problem_of(cluster_hopping(config["cluster"]), bath["levels"],
                      bath["v"], u=float(ed["uloc"][0]),
                      xmu=float(ed.get("xmu", 0.0)),
                      beta=float(ed.get("beta", 1000.0)),
                      lmats=int(ed["lmats"]),
                      ngfiter=int(ed.get("lanc_ngfiter", 200)),
                      half_filling_form=bool(ed.get("hfmode", True)))
