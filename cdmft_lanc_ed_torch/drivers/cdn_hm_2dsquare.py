#!/usr/bin/env python
"""CDMFT driver: Hubbard model on the 2d square lattice, Nx x Ny cluster.

Port of the JAX package's ``drivers/cdn_hm_2dsquare.py`` (the reference's
drivers/cdn_hm_2dsquare.f90).  Reads the same NAME=value input file
(default inputHM2D.conf), runs the CDMFT loop (ed_solve -> Sigma ->
k-summed G_loc -> self-consistency -> chi2 bath fit -> mixing ->
convergence) and prints the observables and the kinetic energy.

    python -m cdmft_lanc_ed_torch.drivers.cdn_hm_2dsquare [--cpu]

``main`` returns the loop's result, the densities, double occupancies and
the kinetic energy.
"""
import argparse

import numpy as np

from cdmft_lanc_ed_torch import EDSolver, read_input
from cdmft_lanc_ed_torch.dmft_loop import run_dmft_loop
from cdmft_lanc_ed_torch.lattice import dmft_kinetic_energy
from cdmft_lanc_ed_torch.models.hubbard import square_cluster_hk


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="inputHM2D.conf")
    ap.add_argument("--nx", type=int, default=2)
    ap.add_argument("--ny", type=int, default=2)
    ap.add_argument("--nk", type=int, default=16)
    ap.add_argument("--ts", type=float, default=1.0)
    ap.add_argument("--wmixing", type=float, default=0.5)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (tests/debug)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    cfg = read_input(args.input, nlat=args.nx * args.ny)
    print(f"CDMFT 2d square: {args.nx}x{args.ny} cluster, "
          f"Nbath={cfg.nbath}, U={cfg.uloc[0]}, beta={cfg.beta}")

    hk, hloc = square_cluster_hk(args.nx, args.ny, args.nk, args.ts,
                                 cfg.nspin, cfg.norb)

    solver = EDSolver(cfg, device=device)
    # symmetry basis: identity (on-site energy) per replica
    # (driver bath setup, cdn_hm_2dsquare.f90:94-108)
    nsym = 1
    basis = np.zeros((nsym, cfg.nlat, cfg.nlat, cfg.nspin, cfg.nspin,
                      cfg.norb, cfg.norb), np.complex128)
    for il in range(cfg.nlat):
        basis[0, il, il, :, :, 0, 0] = np.eye(cfg.nspin)
    lambdas = np.linspace(-cfg.hwband, cfg.hwband, cfg.nbath)[:, None]
    solver.set_hbath(basis, lambdas)
    bath = solver.init_solver()

    res = run_dmft_loop(solver, hk, hloc, bath, wmixing=args.wmixing,
                        log=lambda s: print(s, flush=True))
    print(f"converged={res.converged} after {res.iterations} loops "
          f"(err={res.error:.3e})")
    print("dens =", res.solver.dens().ravel())
    print("docc =", res.solver.docc().ravel())
    ekin = dmft_kinetic_energy(cfg, hk, res.solver.sigma_matsubara(),
                               device=solver.device)
    print("Ekin =", ekin)
    return {"result": res, "dens": res.solver.dens(),
            "docc": res.solver.docc(), "ekin": ekin}


if __name__ == "__main__":
    main()
