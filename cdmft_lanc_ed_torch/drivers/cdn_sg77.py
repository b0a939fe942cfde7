#!/usr/bin/env python
"""CDMFT driver: space-group-77 tetragonal two-orbital model.

Port of the JAX package's ``drivers/cdn_sg77.py`` (the reference's
drivers/cdn_sg77.f90): Nx-site cluster (Nlat=Nx), Norb=2, replica bath
with a single symmetry element (the cluster Hloc structure, lambda=ts;
cdn_sg77.f90:66-74), the standard DMFT loop, and with ``--bands`` the band
structure along the tetragonal high-symmetry path (print_hk,
cdn_sg77.f90:269-306).

    python -m cdmft_lanc_ed_torch.drivers.cdn_sg77 [--cpu] [--bands]

``main`` returns the loop's result, the densities, double occupancies
and, with ``--bands``, the k distances and bands.
"""
import argparse
import os

import numpy as np

from cdmft_lanc_ed_torch import EDSolver, postprocess, read_input
from cdmft_lanc_ed_torch.device import resolve_device
from cdmft_lanc_ed_torch.dmft_loop import run_dmft_loop
from cdmft_lanc_ed_torch.models.sg77 import (sg77_cluster_hk,
                                             sg77_cluster_hloc, sg77_hk_at)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="inputED.conf")
    ap.add_argument("--nx", type=int, default=2,
                    help="cluster sites along x (reference NX)")
    ap.add_argument("--nk", type=int, default=11,
                    help="k-points per BZ axis (reference NK)")
    ap.add_argument("--ts", type=float, default=1.0)
    ap.add_argument("--wmixing", type=float, default=0.5)
    ap.add_argument("--bands", action="store_true",
                    help="write Eigenbands.ed along G-X-M-G-Z-R-A-Z-X-R-M-A")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    cfg = read_input(args.input, nlat=args.nx, norb=2, bath_type="replica")
    print(f"CDMFT sg77: Nx={args.nx} cluster, Nbath={cfg.nbath}, "
          f"ts={args.ts}, Nk={args.nk}^3")
    out = {}

    if args.bands:
        # cdn_sg77.f90:269-306 (print_hk): non-interacting bands
        pts = {"G": [0, 0, 0], "X": [1, 0, 0], "M": [1, 1, 0],
               "Z": [0, 0, 1], "R": [1, 0, 1], "A": [1, 1, 1]}
        path = ["G", "X", "M", "G", "Z", "R", "A", "Z", "X", "R", "M", "A"]
        kpath = [np.pi * np.array(pts[p], float) * [1.0 / args.nx, 1, 1]
                 for p in path]
        kd, bands = postprocess.band_structure(
            lambda k: sg77_hk_at(k, args.nx, args.ts, cfg.nspin), kpath,
            npts=60, device=device)
        np.savetxt(os.path.join(cfg.work_dir, "Eigenbands.ed"),
                   np.column_stack([kd, bands]))
        print("bands written to Eigenbands.ed")
        out.update(kdist=kd, bands=bands)

    hk, hloc = sg77_cluster_hk(args.nx, args.nk, args.ts, cfg.nspin)
    solver = EDSolver(cfg, device=device)
    # bath basis: one symmetry element = Hloc structure at unit amplitude
    basis = sg77_cluster_hloc(args.nx, 1.0, cfg.nspin)[..., None]
    solver.set_hbath(basis, np.full((cfg.nbath, 1), args.ts))
    bath = solver.init_solver()

    res = run_dmft_loop(solver, hk, hloc, bath, wmixing=args.wmixing,
                        log=lambda s: print(s, flush=True))
    print(f"converged={res.converged} after {res.iterations} loops "
          f"(err={res.error:.3e})")
    print("dens =", res.solver.dens())
    print("docc =", res.solver.docc())
    out.update(result=res, dens=res.solver.dens(), docc=res.solver.docc())
    return out


if __name__ == "__main__":
    main()
