#!/usr/bin/env python
"""Minimal smoke-test driver: single-site DMFT on the 2d square lattice.

Port of the JAX package's ``drivers/cdn_test.py`` (the reference's
drivers/cdn_test.f90, its only "test" program): 1 orbital, replica bath,
a few loops, prints the observables.

    python -m cdmft_lanc_ed_torch.drivers.cdn_test [--cpu]

``main`` returns the loop's result, density, double occupancy and egs.
"""
import argparse

import numpy as np

from cdmft_lanc_ed_torch import EDSolver, read_input
from cdmft_lanc_ed_torch.dmft_loop import run_dmft_loop
from cdmft_lanc_ed_torch.models.hubbard import square_cluster_hk


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="inputTEST.conf")
    ap.add_argument("--nk", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    cfg = read_input(args.input, nlat=1, norb=1)
    hk, hloc = square_cluster_hk(1, 1, args.nk)
    solver = EDSolver(cfg, device=device)
    basis = np.zeros((1, 1, 1, cfg.nspin, cfg.nspin, 1, 1), np.complex128)
    basis[0, 0, 0, :, :, 0, 0] = np.eye(cfg.nspin)
    solver.set_hbath(basis,
                     np.linspace(-cfg.hwband, cfg.hwband,
                                 cfg.nbath)[:, None])
    bath = solver.init_solver()
    res = run_dmft_loop(solver, hk, hloc, bath,
                        log=lambda s: print(s, flush=True))
    print(f"converged={res.converged} dens={res.solver.dens().ravel()} "
          f"docc={res.solver.docc().ravel()} egs={res.solver.egs:.8f}")
    return {"result": res, "dens": res.solver.dens(),
            "docc": res.solver.docc(), "egs": res.solver.egs}


if __name__ == "__main__":
    main()
