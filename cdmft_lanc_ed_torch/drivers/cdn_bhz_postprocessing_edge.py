#!/usr/bin/env python
"""Postprocessing driver: BHZ ribbon (edge geometry) spectral function.

Port of the JAX package's ``drivers/cdn_bhz_postprocessing_edge.py`` (the
reference's drivers/cdn_bhz_postprocessing_edge.f90): reads the per-layer
(inequivalent-cluster) real-axis self-energies of a finished BHZ-edge
CDMFT run (Ly layers, an Nx-site cluster per layer, optional left-right
mirror symmetry), periodizes each layer's Sigma along x with the cumulant
scheme keeping the layer's Mh term inside the cumulant
(periodize_sigma_block_real, :553-605), assembles the layer-block-diagonal
ribbon Sigma, and writes the momentum-resolved spectral map
A(kx, w) = log(|det G(kx, w)|/pi/Niso) along kx: 0 -> 2pi (get_Akw,
:611-674) to Akw_real_nso.dat.  The (kx, w) inversions and determinants
run batched over w on the device in complex128.

    python -m cdmft_lanc_ed_torch.drivers.cdn_bhz_postprocessing_edge

``main`` returns the kx grid, the frequencies, the map [Nk, Lreal] and the
real-axis Sigma read back per inequivalent cluster.
"""
import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from cdmft_lanc_ed_torch import read_input
from cdmft_lanc_ed_torch import io as edio
from cdmft_lanc_ed_torch.device import resolve_device
from cdmft_lanc_ed_torch.drivers.cdn_bhz_2d_edge import ineq_map
from cdmft_lanc_ed_torch.models.bhz import t_m, t_x, t_y
from cdmft_lanc_ed_torch.periodize import periodize_m_scheme


def edge_hk_periodized(kx: float, ly: int, mh: float, ts: float,
                       lam: float) -> np.ndarray:
    """x-periodized (1-site cell), y-open BHZ ribbon Hamiltonian
    [Ly*4, Ly*4] (bhz_edge_model_periodized, :528-547): per-layer block
    t_m + t_x e^{ikx} + t_x^H e^{-ikx}, inter-layer t_y blocks."""
    nso = 4
    h = np.zeros((ly, ly, nso, nso), np.complex128)
    for iy in range(ly):
        blk = np.zeros((nso, nso), np.complex128)
        for s in range(2):
            sl = slice(2 * s, 2 * s + 2)
            blk[sl, sl] = (t_m(mh) + t_x(ts, lam, s) * np.exp(1j * kx)
                           + t_x(ts, lam, s).conj().T * np.exp(-1j * kx))
        h[iy, iy] = blk
        if iy + 1 < ly:
            for s in range(2):
                sl = slice(2 * s, 2 * s + 2)
                h[iy + 1, iy][sl, sl] = t_y(ts, lam)
                h[iy, iy + 1][sl, sl] = t_y(ts, lam).T
    return h.transpose(0, 2, 1, 3).reshape(ly * nso, ly * nso)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="inputED.conf")
    ap.add_argument("--nx", type=int, default=2,
                    help="cluster sites along x per layer")
    ap.add_argument("--ly", type=int, default=2,
                    help="ribbon width (number of layers)")
    ap.add_argument("--lrsym", action="store_true", default=True)
    ap.add_argument("--no-lrsym", dest="lrsym", action="store_false")
    ap.add_argument("--nkpath", type=int, default=100)
    ap.add_argument("--ts", type=float, default=0.25)
    ap.add_argument("--mh", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=0.3)
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def spectral_map(cfg, args, sreal_ineq, ks, device=None) -> np.ndarray:
    """A(kx, w) [len(ks), Lreal] of the ribbon from the per-inequivalent
    real-axis Sigma ``sreal_ineq`` (nnn arrays of an Nx-site layer)."""
    device = resolve_device(device)
    nineq, ineq_of = ineq_map(args.ly, args.lrsym)
    wr = np.linspace(cfg.wini, cfg.wfin, cfg.lreal)
    z = wr + 1j * cfg.eps
    nso = 4
    niso = args.ly * nso
    # the layer's Mh term rides inside the cumulant and is subtracted
    # after the periodization
    hmh_nnn = np.zeros((args.nx, args.nx, 2, 2, 2, 2), np.complex128)
    for il in range(args.nx):
        for s in range(2):
            hmh_nnn[il, il, s, s] = t_m(args.mh)
    hmh_per = np.kron(np.eye(2), t_m(args.mh))
    cell = np.arange(args.nx, dtype=float)
    sub = np.zeros(args.nx, int)
    eye = torch.eye(niso, dtype=torch.complex128, device=device)
    zmu = torch.as_tensor(wr + cfg.xmu + 0j).to(device)[:, None, None] * eye
    ak = np.empty((len(ks), cfg.lreal))
    for ik, kx in enumerate(ks):
        sig = torch.zeros((cfg.lreal, niso, niso), dtype=torch.complex128,
                          device=device)
        per = {}
        for layer in range(args.ly):
            ineq = ineq_of(layer)
            if ineq not in per:
                _, s_per = periodize_m_scheme(
                    cfg, [kx], cell, sub, 1,
                    sreal_ineq[ineq] + hmh_nnn[..., None], z, device=device)
                per[ineq] = torch.as_tensor(np.ascontiguousarray(
                    np.moveaxis(s_per - hmh_per[..., None], -1, 0))
                ).to(device)
            sl = slice(layer * nso, (layer + 1) * nso)
            sig[:, sl, sl] = per[ineq]
        hk = torch.as_tensor(edge_hk_periodized(
            kx, args.ly, args.mh, args.ts, args.lam)).to(device)
        gk = torch.linalg.inv(zmu - hk[None] - sig)
        ak[ik] = np.log(torch.linalg.det(gk).abs().cpu().numpy()
                        / np.pi / niso)
    return ak


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    nineq, _ = ineq_map(args.ly, args.lrsym)
    if args.lrsym and args.ly % 2:
        sys.exit("LRSYM requires even Ly")
    cfg = read_input(args.input, nlat=args.nx, norb=2, nspin=2)
    print(f"BHZ edge postprocessing: Nx={args.nx}, Ly={args.ly}, "
          f"Nineq={nineq}")
    wr = np.linspace(cfg.wini, cfg.wfin, cfg.lreal)

    # per-inequivalent-layer self-energies (ed_read_impSigma(Nineq))
    sreal_ineq = []
    for ineq in range(nineq):
        ci = dataclasses.replace(cfg,
                                 ed_file_suffix=f"_ineq{ineq + 1:04d}")
        _, sr = edio.read_impsigma(ci)
        if not np.any(sr):
            print(f"WARNING: no impSigma*_ineq{ineq+1:04d}*realw*.ed in "
                  f"{cfg.work_dir}", file=sys.stderr)
        sreal_ineq.append(sr)

    ks = 2.0 * np.pi * np.arange(2 * args.nkpath) / (2 * args.nkpath)
    ak = spectral_map(cfg, args, sreal_ineq, ks, device=device)
    out = os.path.join(cfg.work_dir, "Akw_real_nso.dat")
    with open(out, "w") as fh:
        for ik, kx in enumerate(ks):
            for iw, w in enumerate(wr):
                fh.write(f"{kx:.9e} {w:.9e} {ak[ik, iw]:.9e}\n")
            fh.write("\n")
    print(f"A(k,w) map written to {out}")
    return {"ks": ks, "wr": wr, "akw": ak, "sreal": np.stack(sreal_ineq),
            "args": args, "cfg": cfg}


if __name__ == "__main__":
    main()
