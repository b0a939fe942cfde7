#!/usr/bin/env python
"""Retrieve a saved self-energy and periodize along a k-path.

Port of the JAX package's ``drivers/retrieve_periodize.py`` (the
reference's drivers/retrieve_periodize_xy.f90): a postprocessing-only
program, no solve.  Reads the impSigma files of work_dir, computes the
k-summed local GF on the real axis and the k-resolved periodized G/Sigma
(G-scheme or Sigma-scheme) along Gamma-X-M-Gamma, and writes text files.

    python -m cdmft_lanc_ed_torch.drivers.retrieve_periodize [--cpu]

``main`` returns the local real-axis GF and the k-path table.
"""
import argparse
import os

import numpy as np

from cdmft_lanc_ed_torch import read_input
from cdmft_lanc_ed_torch import io as ed_io
from cdmft_lanc_ed_torch.lattice import dmft_gloc_realaxis
from cdmft_lanc_ed_torch.models.hubbard import square_cluster_hk
from cdmft_lanc_ed_torch.device import resolve_device
from cdmft_lanc_ed_torch.periodize import build_sigma_g_scheme, \
    cluster_coords, periodize_sigma_scheme


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="inputHM2D.conf")
    ap.add_argument("--nx", type=int, default=2)
    ap.add_argument("--ny", type=int, default=2)
    ap.add_argument("--nk", type=int, default=16)
    ap.add_argument("--ts", type=float, default=1.0)
    ap.add_argument("--scheme", choices=["sigma", "g"], default="g")
    ap.add_argument("--nkpath", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    nlat = args.nx * args.ny
    cfg = read_input(args.input, nlat=nlat)
    smats, sreal = ed_io.read_impsigma(cfg)
    if np.abs(smats).max() == 0:
        print("WARNING: no impSigma found; using Sigma=0")

    hk, hloc = square_cluster_hk(args.nx, args.ny, args.nk, args.ts,
                                 cfg.nspin, cfg.norb)
    # local lattice GF on the real axis (spectral function input)
    greal_loc = dmft_gloc_realaxis(cfg, hk, sreal, device=device)
    wr = np.linspace(cfg.wini, cfg.wfin, cfg.lreal)
    ed_io.splot(os.path.join(cfg.work_dir, "Gloc_realw.ed"), wr,
                greal_loc[0, 0, 0, 0, 0, 0])

    # periodized Sigma along Gamma-X-M-Gamma
    coords = cluster_coords(nlat, args.nx, args.ny)
    wm = np.pi / cfg.beta * (2 * np.arange(min(32, cfg.lmats)) + 1)
    kpts = []
    segs = [(np.zeros(2), np.array([np.pi, 0])),
            (np.array([np.pi, 0]), np.array([np.pi, np.pi])),
            (np.array([np.pi, np.pi]), np.zeros(2))]
    for a, b in segs:
        for t in np.linspace(0, 1, args.nkpath, endpoint=False):
            kpts.append(a + t * (b - a))
    out = []
    for k in kpts:
        eps_k = -2 * args.ts * (np.cos(k[0]) + np.cos(k[1]))
        hk_per = np.full((cfg.nspin * cfg.norb, cfg.nspin * cfg.norb), 0.0,
                         complex)
        np.fill_diagonal(hk_per, eps_k)
        if args.scheme == "sigma":
            g_per, s_per = periodize_sigma_scheme(
                cfg, k, coords, hk_per, smats[..., :len(wm)], 1j * wm,
                device=device)
        else:
            g_per, s_per = build_sigma_g_scheme(
                cfg, k, coords, hk[0], hk_per, smats[..., :len(wm)],
                1j * wm, device=device)
        out.append([k[0], k[1], s_per[0, 0, 0, 0, 0].real,
                    s_per[0, 0, 0, 0, 0].imag,
                    g_per[0, 0, 0, 0, 0].real, g_per[0, 0, 0, 0, 0].imag])
    np.savetxt(os.path.join(cfg.work_dir,
                            f"periodized_{args.scheme}scheme_kpath.ed"),
               np.asarray(out))
    print(f"wrote Gloc_realw.ed and periodized_{args.scheme}scheme_kpath.ed "
          f"({len(kpts)} k-points)")
    return {"gloc_realaxis": greal_loc, "kpath_table": np.asarray(out)}


if __name__ == "__main__":
    main()
