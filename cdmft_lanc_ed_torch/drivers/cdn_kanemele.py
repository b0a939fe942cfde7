#!/usr/bin/env python
"""CDMFT driver: Kane-Mele model, 6-site hexagon cluster.

Port of the JAX package's ``drivers/cdn_kanemele.py`` (the reference's
drivers/cdn_kanemele.f90; Nlat=6, Nspin=2).  ``--bands`` writes the band
structure and the spin Chern numbers / Z2 (the cdn_kanemele_bands
variant); ``--extra-bath-params`` adds the cdn_kanemele_extraBathParams
bath symmetry elements.

    python -m cdmft_lanc_ed_torch.drivers.cdn_kanemele [--cpu] [--bands]

``main`` returns the loop's result, the densities, double occupancies,
the custom density observable and, with ``--bands``, the bands and
(C_up, C_dw, Z2).
"""
import argparse
import os

import numpy as np

from cdmft_lanc_ed_torch import EDSolver, read_input
from cdmft_lanc_ed_torch.custom_obs import CustomObservables
from cdmft_lanc_ed_torch.dmft_loop import run_dmft_loop
from cdmft_lanc_ed_torch.models.kanemele import (kanemele_cluster_hk,
                                                 kanemele_cluster_hloc)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="inputKANEMELE.conf")
    ap.add_argument("--nk", type=int, default=8)
    ap.add_argument("--ts", type=float, default=1.0)
    ap.add_argument("--mh", type=float, default=0.0)
    ap.add_argument("--lam", type=float, default=0.1)
    ap.add_argument("--wmixing", type=float, default=0.5)
    ap.add_argument("--bands", action="store_true",
                    help="write band structure + Z2 "
                         "(cdn_kanemele_bands variant)")
    ap.add_argument("--extra-bath-params", action="store_true",
                    help="add second/third-neighbour bath symmetry elements"
                         " (cdn_kanemele_extraBathParams variant)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    cfg = read_input(args.input, nlat=6, norb=1, nspin=2)
    print(f"CDMFT Kane-Mele: Nbath={cfg.nbath}, U={cfg.uloc[0]}, "
          f"lam={args.lam}, Mh={args.mh}")
    hk, hloc = kanemele_cluster_hk(args.nk, args.ts, args.mh, args.lam)

    solver = EDSolver(cfg, device=device)
    # symmetry basis: the three Hloc components (mass, hop, SOC), as the
    # reference does for BHZ-style drivers
    b1 = kanemele_cluster_hloc(0.0, 1.0, 0.0)
    b2 = kanemele_cluster_hloc(1.0, 0.0, 0.0)
    b3 = kanemele_cluster_hloc(0.0, 0.0, 1.0)
    basis = np.stack([b1, b2, b3])
    lam0 = np.array([args.mh, args.ts, args.lam])
    if args.extra_bath_params:
        # cdn_kanemele_extraBathParams.f90:118-125 + :311-335: two extra
        # spin-diagonal elements, second-neighbour (t2) and opposite-site
        # (t3) hexagon hoppings, at lambda=0 so Hloc is unchanged; the fit
        # is then free to develop them in the bath.
        t2_pairs = [(0, 2), (0, 4), (1, 3), (1, 5), (2, 4), (3, 5)]
        t3_pairs = [(0, 3), (1, 4), (2, 5)]
        extra = np.zeros((2, 6, 6, 2, 2, 1, 1), np.complex128)
        for k, pairs in enumerate((t2_pairs, t3_pairs)):
            for (i, j) in pairs:
                for s in range(2):
                    extra[k, i, j, s, s, 0, 0] = 1.0
                    extra[k, j, i, s, s, 0, 0] = 1.0
        basis = np.concatenate([basis, extra])
        lam0 = np.concatenate([lam0, [0.0, 0.0]])
    solver.set_hbath(basis, np.tile(lam0, (cfg.nbath, 1)))
    bath = solver.init_solver()

    res = run_dmft_loop(solver, hk, hloc, bath, wmixing=args.wmixing,
                        log=lambda s: print(s, flush=True))
    print(f"converged={res.converged} after {res.iterations} loops")
    print("dens =", res.solver.dens().ravel())
    print("docc =", res.solver.docc().ravel())

    # density observable (cdn_kanemele.f90:90-96)
    nlso = cfg.nlso
    obs = np.zeros((nlso, nlso), complex)
    for il in range(6):
        for sp in range(2):
            io = il + sp * 6
            obs[io, io] = 1.0 / 6.0
    co = CustomObservables(res.solver, hk)
    co.add("dens", obs)
    custom = co.compute()
    print("custom:", custom)
    out = {"result": res, "dens": res.solver.dens(),
           "docc": res.solver.docc(), "custom": custom}

    if args.bands:
        from cdmft_lanc_ed_torch import postprocess
        from cdmft_lanc_ed_torch.models.kanemele import (SUPERCELL,
                                                         kanemele_hk_at)
        from cdmft_lanc_ed_torch.utils.reshape import nnn2lso
        b = 2 * np.pi * np.linalg.inv(SUPERCELL).T

        def hk_fn(k):
            return nnn2lso(kanemele_hk_at(k, args.ts, args.mh, args.lam),
                           6, 2, 1)

        kpath = [np.zeros(2), b[0] / 2, (b[0] + b[1]) / 3, np.zeros(2)]
        kd, bands = postprocess.band_structure(hk_fn, kpath, npts=40,
                                               device=solver.device)
        np.savetxt(os.path.join(cfg.work_dir, "kanemele_bands.ed"),
                   np.column_stack([kd, bands]))
        c_up, c_dw, z2 = postprocess.spin_chern_z2(
            hk_fn, b, 10, 12, 3, device=solver.device)
        print(f"bands written; C_up={c_up:+.3f} C_dw={c_dw:+.3f} Z2={z2}")
        out.update(kdist=kd, bands=bands, chern=(c_up, c_dw, z2))
    return out


if __name__ == "__main__":
    main()
