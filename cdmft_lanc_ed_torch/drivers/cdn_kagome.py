#!/usr/bin/env python
"""CDMFT driver: kagome lattice, 3-site triangle cluster.

Port of the JAX package's ``drivers/cdn_kagome.py`` (the reference's
drivers/cdn_kagome.f90; Nlat=3).  ``--bands`` writes the band structure
(the cdn_kagome_bands variant).

    python -m cdmft_lanc_ed_torch.drivers.cdn_kagome [--cpu] [--bands]

``main`` returns the loop's result, the densities, double occupancies
and, with ``--bands``, the k distances and bands.
"""
import argparse
import os

import numpy as np

from cdmft_lanc_ed_torch import EDSolver, read_input
from cdmft_lanc_ed_torch.dmft_loop import run_dmft_loop
from cdmft_lanc_ed_torch.models.kagome import kagome_cluster_hk


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="inputKAGOME.conf")
    ap.add_argument("--nk", type=int, default=10)
    ap.add_argument("--ts", type=float, default=1.0)
    ap.add_argument("--wmixing", type=float, default=0.5)
    ap.add_argument("--bands", action="store_true",
                    help="write band structure (cdn_kagome_bands variant)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    cfg = read_input(args.input, nlat=3, norb=1)
    print(f"CDMFT kagome: Nbath={cfg.nbath}, U={cfg.uloc[0]}")
    hk, hloc = kagome_cluster_hk(args.nk, args.ts, cfg.nspin)

    solver = EDSolver(cfg, device=device)
    basis = np.zeros((1, 3, 3, cfg.nspin, cfg.nspin, 1, 1), np.complex128)
    for il in range(3):
        basis[0, il, il, :, :, 0, 0] = np.eye(cfg.nspin)
    solver.set_hbath(basis, np.linspace(-cfg.hwband, cfg.hwband,
                                        cfg.nbath)[:, None])
    bath = solver.init_solver()

    res = run_dmft_loop(solver, hk, hloc, bath, wmixing=args.wmixing,
                        log=lambda s: print(s, flush=True))
    print(f"converged={res.converged} after {res.iterations} loops")
    print("dens =", res.solver.dens().ravel())
    print("docc =", res.solver.docc().ravel())
    out = {"result": res, "dens": res.solver.dens(),
           "docc": res.solver.docc()}

    if args.bands:
        # cdn_kagome_bands variant: non-interacting band structure
        from cdmft_lanc_ed_torch import postprocess
        from cdmft_lanc_ed_torch.models.kagome import SUPERCELL, kagome_hk_at
        from cdmft_lanc_ed_torch.utils.reshape import nnn2lso
        b = 2 * np.pi * np.linalg.inv(SUPERCELL).T

        def hk_fn(k):
            return nnn2lso(kagome_hk_at(k, args.ts, cfg.nspin), 3,
                           cfg.nspin, 1)

        kpath = [np.zeros(2), b[0] / 2, (b[0] + b[1]) / 3, np.zeros(2)]
        kd, bands = postprocess.band_structure(hk_fn, kpath, npts=40,
                                               device=solver.device)
        np.savetxt(os.path.join(cfg.work_dir, "kagome_bands.ed"),
                   np.column_stack([kd, bands]))
        print("bands written to kagome_bands.ed")
        out.update(kdist=kd, bands=bands)
    return out


if __name__ == "__main__":
    main()
