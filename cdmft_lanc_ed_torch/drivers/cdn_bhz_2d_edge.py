#!/usr/bin/env python
"""CDMFT driver: BHZ ribbon with per-layer inequivalent clusters.

Port of the JAX package's ``drivers/cdn_bhz_2d_edge.py`` (the reference's
drivers/cdn_bhz_2d_edge.f90): an Ly-layer ribbon (x-periodic, open y),
each layer an Nx-site cluster solved as an inequivalent impurity problem
(real-space CDMFT through :class:`LatticeSolver`), with the optional
left-right mirror symmetry halving the number of solved layers (lrsym,
:76-82).  The lattice G is the full ribbon k-sum with the
layer-block-diagonal self-energy (:146-152); the self-consistency and the
bath fit run per layer.

    python -m cdmft_lanc_ed_torch.drivers.cdn_bhz_2d_edge --input FILE

``main`` returns the lattice solver, the per-layer Sigma and Weiss fields,
the baths, the error per iteration and the seconds of each stage.
"""
import argparse
import dataclasses
import sys
import time

import numpy as np

from cdmft_lanc_ed_torch import read_input
from cdmft_lanc_ed_torch.lattice import (ConvergenceCheck,
                                         dmft_gloc_matsubara,
                                         dmft_self_consistency)
from cdmft_lanc_ed_torch.lattice_solver import LatticeSolver
from cdmft_lanc_ed_torch.models.bhz import (bhz_bath_basis, bhz_chain_hk,
                                            bhz_cluster_hloc)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="inputED.conf")
    ap.add_argument("--nx", type=int, default=2,
                    help="cluster sites along x per layer")
    ap.add_argument("--ly", type=int, default=2,
                    help="ribbon width (layers along open y)")
    ap.add_argument("--lrsym", action="store_true", default=True)
    ap.add_argument("--no-lrsym", dest="lrsym", action="store_false")
    ap.add_argument("--nk", type=int, default=32)
    ap.add_argument("--ts", type=float, default=0.25)
    ap.add_argument("--mh", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=0.3)
    ap.add_argument("--wmixing", type=float, default=0.5)
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def ineq_map(ly: int, lrsym: bool):
    """(Nineq, layer -> inequivalent cluster): with lrsym layer l and layer
    Ly-1-l share a cluster (isites2ineq)."""
    nineq = ly // 2 if lrsym else ly

    def ineq_of(layer):
        return layer if layer < nineq or not lrsym else ly - layer - 1

    return nineq, ineq_of


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    nx, ly = args.nx, args.ly
    if args.lrsym and ly % 2:
        sys.exit("LRSYM requires even Ly")
    nineq, ineq_of = ineq_map(ly, args.lrsym)
    cfg = read_input(args.input, nlat=nx, norb=2, nspin=2,
                     bath_type="replica")
    print(f"CDMFT BHZ edge: Nx={nx} x Ly={ly} ribbon, Nineq={nineq}, "
          f"Nbath={cfg.nbath}")

    # ribbon H(kx): x-periodic Nx-cluster per layer + t_y between layers
    hk, _ = bhz_chain_hk(nx, ly, args.nk, args.mh, args.ts, args.lam)
    hloc_layer = bhz_cluster_hloc(nx, 1, args.mh, args.ts, args.lam)
    hloc_ineq = np.broadcast_to(hloc_layer,
                                (nineq,) + hloc_layer.shape).copy()
    cfg_big = dataclasses.replace(cfg, nlat=nx * ly)

    ls = LatticeSolver(cfg, nineq=nineq, device=device)
    basis, lam0 = bhz_bath_basis(nx, 1, args.mh, args.ts, args.lam)
    ls.set_hbath(basis, np.tile(lam0, (nineq, cfg.nbath, 1)))
    baths = ls.init_solver()
    baths_prev = None

    conv = ConvergenceCheck(cfg.dmft_error, cfg.nsuccess)
    nlat_big = nx * ly
    errors, timings = [], []
    done = False
    smats_ineq = weiss_ineq = None
    for iloop in range(1, cfg.nloop + 1):
        print(f"DMFT loop {iloop}/{cfg.nloop}", flush=True)
        ls.solve(baths, hloc_ineq)
        t = {"solve_s": list(ls.solve_seconds),
             "stages_s": [dict(s.timers.totals) for s in ls.solvers]}
        smats_ineq = ls.sigma_matsubara()         # [nineq, nx, nx, ...]

        # layer-block-diagonal ribbon Sigma (site i = ix + layer*nx)
        t0 = time.time()
        smats_big = np.zeros((nlat_big, nlat_big) + smats_ineq.shape[3:],
                             np.complex128)
        for layer in range(ly):
            sl = slice(layer * nx, (layer + 1) * nx)
            smats_big[sl, sl] = smats_ineq[ineq_of(layer)]
        gloc_big = dmft_gloc_matsubara(cfg_big, hk, smats_big,
                                       device=ls.device)
        t["gloc_s"] = time.time() - t0

        # per-inequivalent-layer self-consistency
        t0 = time.time()
        weiss_ineq = np.empty_like(smats_ineq)
        for ineq in range(nineq):
            sl = slice(ineq * nx, (ineq + 1) * nx)
            weiss_ineq[ineq] = dmft_self_consistency(
                cfg, gloc_big[sl, sl], smats_ineq[ineq],
                hloc_ineq[ineq], scheme=cfg.cg_scheme, device=ls.device)
        t["weiss_s"] = time.time() - t0

        t0 = time.time()
        new_baths = ls.fit(weiss_ineq, baths, hloc_ineq=hloc_ineq)
        t["fit_s"] = time.time() - t0
        if baths_prev is not None:
            new_baths = args.wmixing * new_baths \
                + (1 - args.wmixing) * baths_prev
        baths_prev = new_baths.copy()
        baths = new_baths

        done = conv(weiss_ineq.ravel())
        errors.append(conv.error)
        timings.append(t)
        print(f"  error={conv.error:.3e} "
              f"dens={ls.dens().sum():.6f}", flush=True)
        if done:
            break

    print(f"converged={done} after {iloop} loops (err={conv.error:.3e})")
    print("dens per layer =", ls.dens().reshape(nineq, -1).sum(axis=1))
    print("docc =", ls.docc().ravel())
    return {"solver": ls, "smats": smats_ineq, "weiss": weiss_ineq,
            "baths": baths, "errors": errors, "timings": timings,
            "converged": done, "dens": ls.dens(), "docc": ls.docc(),
            "egs": ls.egs()}


if __name__ == "__main__":
    main()
