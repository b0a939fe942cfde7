#!/usr/bin/env python
"""BHZ postprocessing: periodized Sigma, topological Hamiltonian, Z2.

Port of the JAX package's ``drivers/cdn_bhz_postprocessing.py`` (the
reference's drivers/cdn_bhz_postprocessing.f90): reads a converged
self-energy (the impSigma files of cdn_bhz_2d), builds periodized
quantities, the topological Hamiltonian
H_top(k) = H_per(k) + Re Sigma_per(k, w->0), band structures along the
reference's k path, quasiparticle weights and Z(k), and the interacting
Z2 invariant.

    python -m cdmft_lanc_ed_torch.drivers.cdn_bhz_postprocessing [--cpu]

``main`` returns Z, the topological bands, the unperiodized bands, the
Z(k) maps and (C_up, C_dw, Z2).
"""
import argparse
import os

import numpy as np

from cdmft_lanc_ed_torch import read_input, postprocess
from cdmft_lanc_ed_torch import io as ed_io
from cdmft_lanc_ed_torch.device import resolve_device
from cdmft_lanc_ed_torch.models.bhz import bhz_cluster_hk, t_x, t_y, \
    bhz_cluster_hloc
from cdmft_lanc_ed_torch.periodize import build_sigma_g_scheme, \
    cluster_coords, periodize_m_scheme_local, periodize_sigma_scheme
from cdmft_lanc_ed_torch.utils.reshape import nn2so, nnn2lso


def single_cell_hk(mh, ts, lam):
    def hk(k):
        h = bhz_cluster_hloc(1, 1, mh, ts, lam).copy()
        for s in range(2):
            h[0, 0, s, s] += t_x(ts, lam, s).conj().T * np.exp(1j * k[0]) \
                + t_x(ts, lam, s) * np.exp(-1j * k[0]) \
                + t_y(ts, lam).T * np.exp(1j * k[1]) \
                + t_y(ts, lam) * np.exp(-1j * k[1])
        return nnn2lso(h, 1, 2, 2)
    return hk


def cluster_hk_fn(nx, ny, mh, ts, lam):
    """Function-of-k cluster Bloch Hamiltonian [Nlso, Nlso] (hk_model on
    the cluster-tiled BZ, cdn_bhz_2d.f90:251-276)."""
    nlat = nx * ny

    def idx(ix, iy):
        return ix + iy * nx

    def hk(k):
        h = np.array(bhz_cluster_hloc(nx, ny, mh, ts, lam))
        for s in range(2):
            for iy in range(ny):
                a, b = idx(0, iy), idx(nx - 1, iy)
                h[b, a, s, s] += t_x(ts, lam, s).conj().T \
                    * np.exp(1j * k[0] * nx)
                h[a, b, s, s] += t_x(ts, lam, s) * np.exp(-1j * k[0] * nx)
            for ix in range(nx):
                a, b = idx(ix, 0), idx(ix, ny - 1)
                h[b, a, s, s] += t_y(ts, lam).T * np.exp(1j * k[1] * ny)
                h[a, b, s, s] += t_y(ts, lam) * np.exp(-1j * k[1] * ny)
        return nnn2lso(h, nlat, 2, 2)

    return hk


# the reference's 7-point -Y G Y M X G -X path
# (print_hk_topological_path, cdn_bhz_postprocessing.f90:749-779)
def _bhz_kpath():
    Y = np.array([0.0, np.pi])
    X = np.array([np.pi, 0.0])
    M = np.array([np.pi, np.pi])
    G = np.zeros(2)
    return [-Y, G, Y, M, X, G, -X]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="inputBHZ.conf")
    ap.add_argument("--nx", type=int, default=2)
    ap.add_argument("--ny", type=int, default=2)
    ap.add_argument("--ts", type=float, default=0.25)
    ap.add_argument("--mh", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=0.3)
    ap.add_argument("--scheme", choices=["sigma", "g", "m"],
                    default="sigma",
                    help="periodization: sigma / g / m (local-cumulant "
                         "M-scheme, cdn_bhz_postprocessing.f90:641-712)")
    ap.add_argument("--nk-chern", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    nlat = args.nx * args.ny
    cfg = read_input(args.input, nlat=nlat, norb=2, nspin=2,
                     bath_type="general")
    smats, sreal = ed_io.read_impsigma(cfg)
    if np.abs(smats).max() == 0.0:
        print("WARNING: no impSigma files found in work_dir; "
              "using Sigma=0 (non-interacting postprocessing)")

    coords = cluster_coords(nlat, args.nx, args.ny)
    hk_unper, _ = bhz_cluster_hk(args.nx, args.ny, 1, args.mh, args.ts,
                                 args.lam)
    hk_per_fn = single_cell_hk(args.mh, args.ts, args.lam)
    wm = np.pi / cfg.beta * (2 * np.arange(min(8, cfg.lmats)) + 1)

    # quasiparticle weight from the cluster Sigma
    z = postprocess.quasiparticle_weight(cfg, smats)
    print("Z (diagonal lso):", z)

    # M-scheme ingredients: local cluster H (hoppings zeroed) + the
    # hopping-only and full periodized Bloch matrices
    h_local = nnn2lso(bhz_cluster_hloc(args.nx, args.ny, args.mh, 0.0,
                                       0.0), nlat, 2, 2)
    hk_hop_fn = single_cell_hk(0.0, args.ts, args.lam)

    def sigma_per_mats(k, z):
        if args.scheme == "sigma":
            _, s_per = periodize_sigma_scheme(cfg, k, coords, hk_per_fn(k),
                                              smats[..., :len(z)], z,
                                              device=device)
        elif args.scheme == "m":
            _, s_per = periodize_m_scheme_local(
                cfg, k, coords, h_local, hk_hop_fn(k), hk_per_fn(k),
                smats[..., :len(z)], z, device=device)
        else:
            _, s_per = build_sigma_g_scheme(cfg, k, coords, hk_unper[0],
                                            hk_per_fn(k),
                                            smats[..., :len(z)], z,
                                            device=device)
        return s_per

    def sigma0_of_k(k):
        return nn2so(sigma_per_mats(k, 1j * wm)[..., 0], cfg.nspin,
                     cfg.norb)

    htop = postprocess.topological_hamiltonian(hk_per_fn, sigma0_of_k)

    # periodized Sigma/G print files at Gamma (perSigma_<scheme>scheme,
    # cdn_bhz_postprocessing.f90:384-399,697-710)
    tag = {"sigma": "sscheme", "g": "gscheme", "m": "mscheme"}[args.scheme]
    s_g = sigma_per_mats(np.zeros(2), 1j * np.pi / cfg.beta
                         * (2 * np.arange(cfg.lmats) + 1))
    s_g_so = nn2so(s_g, cfg.nspin, cfg.norb)
    nso = cfg.nspin * cfg.norb
    wmf = np.pi / cfg.beta * (2 * np.arange(cfg.lmats) + 1)
    for io_ in range(nso):
        for jo in range(nso):
            ed_io.splot(os.path.join(
                cfg.work_dir, f"perSigma_{tag}_l{io_+1}m{jo+1}_iw.ed"),
                wmf, s_g_so[io_, jo])

    def sigma_iw1_so(k):
        """Complex periodized Sigma(k, iw_1) in so form (zmats input)."""
        return nn2so(sigma_per_mats(k, 1j * wm[:1])[..., 0], cfg.nspin,
                     cfg.norb)

    def _sample_path(kpath, npts):
        ks, dist = [], [0.0]
        for a, b in zip(kpath[:-1], kpath[1:]):
            seg = np.linspace(0, 1, npts, endpoint=False)[:, None] \
                * (np.asarray(b) - np.asarray(a))[None] + np.asarray(a)
            ks.extend(seg)
        ks.append(np.asarray(kpath[-1]))
        for i in range(1, len(ks)):
            dist.append(dist[-1] + np.linalg.norm(ks[i] - ks[i - 1]))
        return np.asarray(dist), ks

    # Z(k) maps at the 4 high-symmetry points (print_zmats,
    # cdn_bhz_postprocessing.f90:813-836) + the component map along the
    # 7-point path (print_zmats_path / zmats_component, lines 291-304)
    kpts4 = [np.zeros(2), np.array([np.pi, 0.0]), np.array([0.0, np.pi]),
             np.array([np.pi, np.pi])]
    zk = np.stack([postprocess.zmats_matrix(cfg, sigma_iw1_so(k))
                   for k in kpts4])
    for (i, j) in [(0, 0), (0, 1), (1, 0), (1, 1)]:
        ed_io.splot(os.path.join(cfg.work_dir, f"Zk{i+1}{j+1}.dat"),
                    np.arange(1.0, 5.0), zk[:, i, j].astype(complex))
    kd_z, kpts_z = _sample_path(_bhz_kpath(), 8)
    zpath = np.stack([np.diag(postprocess.zmats_component(
        cfg, sigma_iw1_so(k))) for k in kpts_z])
    np.savetxt(os.path.join(cfg.work_dir, "Zk_component_path.ed"),
               np.column_stack([kd_z, zpath.real]))

    # band structure along the reference 7-point path (Eig_Htop.ed)
    kd, bands = postprocess.band_structure(htop, _bhz_kpath(), npts=30,
                                           device=device)
    out = os.path.join(cfg.work_dir, "topological_bands.ed")
    np.savetxt(out, np.column_stack([kd, bands]))
    print(f"bands written to {out}; gap at half filling: "
          f"{(bands[:, 2] - bands[:, 1]).min():.6f}")

    # unperiodized (cluster-BZ) topological bands
    # (Eig_Htop_unperiodized.ed, cdn_bhz_postprocessing.f90:781-811;
    # kx halved for the folded x-axis, reference line 801)
    s_cl0 = nnn2lso(smats[..., 0], nlat, cfg.nspin, cfg.norb)
    htop_u = postprocess.unperiodized_topological_hamiltonian(
        cluster_hk_fn(args.nx, args.ny, args.mh, args.ts, args.lam),
        s_cl0)
    kpath_u = [np.array([k[0] / 2.0, k[1]]) for k in _bhz_kpath()]
    kd_u, bands_u = postprocess.band_structure(htop_u, kpath_u, npts=30,
                                               device=device)
    np.savetxt(os.path.join(cfg.work_dir, "Eig_Htop_unperiodized.ed"),
               np.column_stack([kd_u, bands_u]))

    # interacting Z2 from the topological Hamiltonian
    recip = 2 * np.pi * np.eye(2)
    c_up, c_dw, z2 = postprocess.spin_chern_z2(htop, recip, args.nk_chern,
                                               4, 1, device=device)
    print(f"C_up={c_up:+.4f} C_dw={c_dw:+.4f}  Z2={z2}")
    return {"z": z, "zk": zk, "zpath": zpath, "kdist": kd, "bands": bands,
            "bands_unperiodized": bands_u, "sigma_gamma": s_g,
            "chern": (c_up, c_dw, z2)}


if __name__ == "__main__":
    main()
