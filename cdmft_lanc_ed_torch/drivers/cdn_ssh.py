#!/usr/bin/env python
"""CDMFT driver: SSH dimerised Hubbard chain.

Port of the JAX package's ``drivers/cdn_ssh.py`` (the reference's
drivers/cdn_ssh.f90; Nlat = 2*Ndimer).

    python -m cdmft_lanc_ed_torch.drivers.cdn_ssh [--cpu]

``main`` returns the loop's result, the densities and double occupancies.
"""
import argparse

import numpy as np

from cdmft_lanc_ed_torch import EDSolver, read_input
from cdmft_lanc_ed_torch.dmft_loop import run_dmft_loop
from cdmft_lanc_ed_torch.models.ssh import ssh_cluster_hk


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="inputSSH.conf")
    ap.add_argument("--ndimer", type=int, default=1)
    ap.add_argument("--nk", type=int, default=64)
    ap.add_argument("--ts", type=float, default=0.5)
    ap.add_argument("--delta", type=float, default=0.1)
    ap.add_argument("--wmixing", type=float, default=0.5)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    nlat = 2 * args.ndimer
    cfg = read_input(args.input, nlat=nlat, norb=1)
    print(f"CDMFT SSH: Ndimer={args.ndimer}, delta={args.delta}, "
          f"Nbath={cfg.nbath}, U={cfg.uloc[0]}")
    hk, hloc = ssh_cluster_hk(args.ndimer, args.nk, args.ts, args.delta,
                              cfg.nspin)

    solver = EDSolver(cfg, device=device)
    basis = np.zeros((1, nlat, nlat, cfg.nspin, cfg.nspin, 1, 1),
                     np.complex128)
    for il in range(nlat):
        basis[0, il, il, :, :, 0, 0] = np.eye(cfg.nspin)
    solver.set_hbath(basis, np.linspace(-cfg.hwband, cfg.hwband,
                                        cfg.nbath)[:, None])
    bath = solver.init_solver()

    res = run_dmft_loop(solver, hk, hloc, bath, wmixing=args.wmixing,
                        log=lambda s: print(s, flush=True))
    print(f"converged={res.converged} after {res.iterations} loops")
    print("dens =", res.solver.dens().ravel())
    print("docc =", res.solver.docc().ravel())
    return {"result": res, "dens": res.solver.dens(),
            "docc": res.solver.docc()}


if __name__ == "__main__":
    main()
