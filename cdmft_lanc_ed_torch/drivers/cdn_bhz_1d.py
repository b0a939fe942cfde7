#!/usr/bin/env python
"""CDMFT driver: BHZ chain (1d), Nx-site cluster.

Port of the JAX package's ``drivers/cdn_bhz_1d.py`` (the reference's
drivers/cdn_bhz_1d.f90; Ny=1, x-periodic).  With --ny > 1 this is the
ribbon geometry of cdn_bhz_2d_edge.f90 as one cluster (x-periodic strip,
open y).

    python -m cdmft_lanc_ed_torch.drivers.cdn_bhz_1d [--cpu]

``main`` returns the loop's result, the densities and double occupancies.
"""
import argparse

import numpy as np

from cdmft_lanc_ed_torch import EDSolver, read_input
from cdmft_lanc_ed_torch.dmft_loop import run_dmft_loop
from cdmft_lanc_ed_torch.models.bhz import bhz_bath_basis, bhz_chain_hk


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="inputBHZ1D.conf")
    ap.add_argument("--nx", type=int, default=2)
    ap.add_argument("--ny", type=int, default=1,
                    help=">1 gives the edge/ribbon geometry")
    ap.add_argument("--nk", type=int, default=32)
    ap.add_argument("--ts", type=float, default=0.25)
    ap.add_argument("--mh", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=0.3)
    ap.add_argument("--wmixing", type=float, default=0.5)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    nlat = args.nx * args.ny
    cfg = read_input(args.input, nlat=nlat, norb=2, nspin=2,
                     bath_type="general")
    geom = "chain" if args.ny == 1 else f"ribbon(ny={args.ny})"
    print(f"CDMFT BHZ {geom}: Nx={args.nx}, Nbath={cfg.nbath}, "
          f"Mh={args.mh}")
    hk, hloc = bhz_chain_hk(args.nx, args.ny, args.nk, args.mh, args.ts,
                            args.lam)
    solver = EDSolver(cfg, device=device)
    basis, lam0 = bhz_bath_basis(args.nx, args.ny, args.mh, args.ts,
                                 args.lam)
    solver.set_hbath(basis, np.tile(lam0, (cfg.nbath, 1)))
    bath = solver.init_solver()
    res = run_dmft_loop(solver, hk, hloc, bath, wmixing=args.wmixing,
                        log=lambda s: print(s, flush=True))
    print(f"converged={res.converged} after {res.iterations} loops")
    print("dens =", res.solver.dens())
    print("docc =", res.solver.docc())
    return {"result": res, "dens": res.solver.dens(),
            "docc": res.solver.docc()}


if __name__ == "__main__":
    main()
