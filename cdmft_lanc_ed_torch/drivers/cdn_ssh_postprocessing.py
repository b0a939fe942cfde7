#!/usr/bin/env python
"""Postprocessing driver: SSH chain, M-scheme (cumulant) periodization.

Port of the JAX package's ``drivers/cdn_ssh_postprocessing.py`` (the
reference's drivers/cdn_ssh_postprocessing.f90): reads a stored impurity
self-energy (real axis) of a finished cdn_ssh run, then
  * det-G spectral map A(k,w) = log(|det G_per(k,w)|/pi/Niso) along the
    k-path -pi -> 0 -> pi (get_det_G, :391-449) -> det_G_real_nso.dat
  * k-averaged M-scheme periodized Sigma and cumulant written as
    perSigma/perG component files (get_local_sigma/g, :456-511).
The (k, w) inversions run batched over w on the device.

    python -m cdmft_lanc_ed_torch.drivers.cdn_ssh_postprocessing [--cpu]

``main`` returns the k path, the map and the k-averaged Sigma and M.
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
from cdmft_lanc_ed_torch.periodize import periodize_m_scheme
from cdmft_lanc_ed_torch.utils.reshape import lso2nnn


def hk_periodized(k: float, vhop: float, whop: float,
                  nspin: int) -> np.ndarray:
    """Minimal-unit-cell (single dimer) SSH Bloch Hamiltonian
    (hk_periodized, cdn_ssh_postprocessing.f90:187-202)."""
    hop = -vhop - whop * np.exp(-1j * k)
    h2 = np.array([[0.0, hop], [np.conj(hop), 0.0]])
    return np.kron(np.eye(nspin), h2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="inputED.conf")
    ap.add_argument("--ndimer", type=int, default=1)
    ap.add_argument("--vhop", type=float, default=0.25)
    ap.add_argument("--whop", type=float, default=0.25)
    ap.add_argument("--nk", type=int, default=10)
    ap.add_argument("--nkpath", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    nlat = 2 * args.ndimer
    cfg = read_input(args.input, nlat=nlat, norb=1, bath_type="replica")
    print(f"SSH postprocessing: Ndimer={args.ndimer}, vhop={args.vhop}, "
          f"whop={args.whop}")

    _, sreal = edio.read_impsigma(cfg)
    if not np.any(sreal):
        print("WARNING: no impSigma_*realw*.ed files found in "
              f"{cfg.work_dir}; run cdn_ssh first", file=sys.stderr)
    wr = np.linspace(cfg.wini, cfg.wfin, cfg.lreal)
    z = wr + 1j * cfg.eps
    niso = 2 * cfg.nspin

    # site i belongs to dimer i//2 (cell position) at sublattice i%2
    cell = np.repeat(np.arange(args.ndimer, dtype=float), 2)
    sub = np.tile([0, 1], args.ndimer)

    # --- det-G map along -pi -> 0 -> pi (get_det_G) -----------------------
    ks = np.concatenate([np.linspace(-np.pi, 0.0, args.nkpath,
                                     endpoint=False),
                         np.linspace(0.0, np.pi, args.nkpath)])
    ak = np.empty((len(ks), cfg.lreal))
    zmu = torch.as_tensor(z + cfg.xmu).to(device)[:, None, None] \
        * torch.eye(niso, dtype=torch.complex128, device=device)
    for i, k in enumerate(ks):
        _, s_per = periodize_m_scheme(cfg, [k], cell, sub, 2, sreal, z,
                                      device=device)
        hkp = hk_periodized(k, args.vhop, args.whop, cfg.nspin)
        a = zmu - torch.as_tensor(hkp).to(device)[None] \
            - torch.as_tensor(np.ascontiguousarray(
                np.moveaxis(s_per, -1, 0))).to(device)
        gk = torch.linalg.inv(a)
        ak[i] = np.log(torch.linalg.det(gk).abs().cpu().numpy()
                       / np.pi / niso)
    out = os.path.join(cfg.work_dir, "det_G_real_nso.dat")
    with open(out, "w") as fh:
        for i, k in enumerate(ks):
            for iw, w in enumerate(wr):
                fh.write(f"{k:.9e} {w:.9e} {ak[i, iw]:.9e}\n")
            fh.write("\n")
    print(f"det-G map written to {out}")

    # --- k-averaged periodized Sigma / cumulant (get_local_sigma/g) -------
    kgrid = 2.0 * np.pi * np.arange(args.nk) / args.nk
    s_loc = np.zeros((niso, niso, cfg.lreal), complex)
    m_loc = np.zeros_like(s_loc)
    for k in kgrid:
        m_per, s_per = periodize_m_scheme(cfg, [k], cell, sub, 2, sreal, z,
                                          device=device)
        s_loc += s_per / args.nk
        m_loc += m_per / args.nk
    cfg2 = dataclasses.replace(cfg, nlat=2)   # periodized: 2-site cell
    edio._print_function(cfg2, lso2nnn(s_loc, 2, cfg.nspin, 1), wr,
                         "perSigma", "realw")
    edio._print_function(cfg2, lso2nnn(m_loc, 2, cfg.nspin, 1), wr,
                         "perG", "realw")
    print("periodized local Sigma/G written (perSigma*/perG* realw)")
    return {"ks": ks, "akw": ak, "sigma_loc": s_loc, "m_loc": m_loc}


if __name__ == "__main__":
    main()
