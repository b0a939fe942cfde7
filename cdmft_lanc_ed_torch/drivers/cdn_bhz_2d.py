#!/usr/bin/env python
"""CDMFT driver: BHZ model on the 2d square lattice, Nx x Ny cluster.

Port of the JAX package's ``drivers/cdn_bhz_2d.py`` (the reference's
drivers/cdn_bhz_2d.f90): Norb=2, Nspin=2, complex spin-dependent
hopping, general bath, a custom observable (the orbital-2 density) and a
periodized self-energy sample.

    python -m cdmft_lanc_ed_torch.drivers.cdn_bhz_2d [--cpu]

``main`` returns the loop's result, the densities, double occupancies,
the custom observable, the periodized Sigma at Gamma and the kinetic
energy.
"""
import argparse

import numpy as np

from cdmft_lanc_ed_torch import EDSolver, read_input
from cdmft_lanc_ed_torch.custom_obs import CustomObservables
from cdmft_lanc_ed_torch.dmft_loop import run_dmft_loop
from cdmft_lanc_ed_torch.lattice import dmft_kinetic_energy
from cdmft_lanc_ed_torch.models.bhz import bhz_bath_basis, bhz_cluster_hk
from cdmft_lanc_ed_torch.periodize import (build_sigma_g_scheme,
                                           cluster_coords)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="inputBHZ.conf")
    ap.add_argument("--nx", type=int, default=2)
    ap.add_argument("--ny", type=int, default=2)
    ap.add_argument("--nk", type=int, default=10)
    ap.add_argument("--ts", type=float, default=0.25)
    ap.add_argument("--mh", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=0.3)
    ap.add_argument("--wmixing", type=float, default=0.5)
    ap.add_argument("--adaptive-mix", action="store_true",
                    help="error-adaptive bath mixing "
                         "(cdn_bhz_2d_adaptive_mix variant)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    nlat = args.nx * args.ny
    cfg = read_input(args.input, nlat=nlat, norb=2, nspin=2,
                     bath_type="general")
    print(f"CDMFT BHZ 2d: {args.nx}x{args.ny} cluster, Nbath={cfg.nbath}, "
          f"Mh={args.mh}, lambda={args.lam}")
    hk, hloc = bhz_cluster_hk(args.nx, args.ny, args.nk, args.mh, args.ts,
                              args.lam)
    solver = EDSolver(cfg, device=device)
    basis, lam0 = bhz_bath_basis(args.nx, args.ny, args.mh, args.ts,
                                 args.lam)
    solver.set_hbath(basis, np.tile(lam0, (cfg.nbath, 1)))
    bath = solver.init_solver()

    res = run_dmft_loop(solver, hk, hloc, bath, wmixing=args.wmixing,
                        adaptive_mixing=args.adaptive_mix,
                        log=lambda s: print(s, flush=True))
    print(f"converged={res.converged} after {res.iterations} loops "
          f"(err={res.error:.3e})")
    print("dens =", res.solver.dens())
    print("docc =", res.solver.docc())

    # custom observables: orbital-2 density (cdn_bhz_2d.f90:94-103)
    obs_mat = np.zeros((cfg.nlso, cfg.nlso), complex)
    for il in range(nlat):
        for sp in range(2):
            io = 1 + il * 2 + sp * 2 * nlat
            obs_mat[io, io] = 1.0 / nlat
    co = CustomObservables(res.solver, hk)
    co.add("n2", obs_mat)
    custom = co.compute()
    print("custom:", custom)

    # periodized Sigma at the Gamma point (postprocessing sample)
    coords = cluster_coords(nlat, args.nx, args.ny)
    nw = min(8, cfg.lmats)
    wm = np.pi / cfg.beta * (2 * np.arange(nw) + 1)
    hk_per, _ = bhz_cluster_hk(1, 1, 1, args.mh, args.ts, args.lam)
    g_per, s_per = build_sigma_g_scheme(
        cfg, [0.0, 0.0], coords, hk[0], hk_per[0],
        res.solver.sigma_matsubara()[..., :nw], 1j * wm,
        device=solver.device)
    print("Sigma_per(Gamma, iw0) diag:",
          np.real(np.diagonal(s_per[..., 0].reshape(4, 4))))
    ekin = dmft_kinetic_energy(cfg, hk, res.solver.sigma_matsubara(),
                               device=solver.device)
    print("Ekin =", ekin)
    return {"result": res, "dens": res.solver.dens(),
            "docc": res.solver.docc(), "custom": custom, "g_per": g_per,
            "s_per": s_per, "ekin": ekin}


if __name__ == "__main__":
    main()
