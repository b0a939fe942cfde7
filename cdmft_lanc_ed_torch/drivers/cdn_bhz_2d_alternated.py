#!/usr/bin/env python
"""CDMFT driver: BHZ model, 2-site cluster on the alternated
(checkerboard / 45-degree-rotated) superlattice.

Port of the JAX package's ``drivers/cdn_bhz_2d_alternated.py`` (the
reference's drivers/cdn_bhz_2d_alternated.f90): a (Nx=2, Ny=1) cluster
tiles the square lattice with period sqrt(2), replica bath from the
3-element Hloc symmetry basis (Mh/ts/lambda), kinetic energy at the end.

    python -m cdmft_lanc_ed_torch.drivers.cdn_bhz_2d_alternated [--cpu]

``main`` returns the loop's result, the densities, double occupancies and
the kinetic energy.
"""
import argparse

import numpy as np

from cdmft_lanc_ed_torch import EDSolver, read_input
from cdmft_lanc_ed_torch.dmft_loop import run_dmft_loop
from cdmft_lanc_ed_torch.lattice import dmft_kinetic_energy
from cdmft_lanc_ed_torch.models.bhz import bhz_alternated_hk, bhz_bath_basis


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="inputED.conf")
    ap.add_argument("--nk", type=int, default=10)
    ap.add_argument("--ts", type=float, default=0.25)
    ap.add_argument("--mh", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=0.3)
    ap.add_argument("--wmixing", type=float, default=1.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    cfg = read_input(args.input, nlat=2, norb=2, nspin=2,
                     bath_type="replica")
    print(f"CDMFT BHZ alternated: 2-site cluster, Nbath={cfg.nbath}, "
          f"Mh={args.mh}, lambda={args.lam}")
    hk, hloc = bhz_alternated_hk(args.nk, args.mh, args.ts, args.lam)

    solver = EDSolver(cfg, device=device)
    basis, lam0 = bhz_bath_basis(2, 1, args.mh, args.ts, args.lam)
    solver.set_hbath(basis, np.tile(lam0, (cfg.nbath, 1)))
    bath = solver.init_solver()

    res = run_dmft_loop(solver, hk, hloc, bath, wmixing=args.wmixing,
                        log=lambda s: print(s, flush=True))
    print(f"converged={res.converged} after {res.iterations} loops "
          f"(err={res.error:.3e})")
    print("dens =", res.solver.dens())
    print("docc =", res.solver.docc())
    ekin = dmft_kinetic_energy(cfg, hk, res.solver.sigma_matsubara(),
                               device=solver.device)
    print("Ekin =", ekin)
    return {"result": res, "dens": res.solver.dens(),
            "docc": res.solver.docc(), "ekin": ekin}


if __name__ == "__main__":
    main()
