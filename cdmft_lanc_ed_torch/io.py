"""IO: text-file printers/readers and reduced density matrices.

Port of the JAX package's ``io.py`` (the reference's ED_IO.f90 +
ED_IO/*.f90), host numpy: the files are small and the arrays already on
the host.  File names and number formats match the reference exactly, so
that postprocessing scripts written for the reference (and the JAX
package's readers) read the port's files unchanged:

  impSigma_Isite0001_Jsite0002_l11_s1_iw.ed     (splot 3-column format)
  impG_..._realw.ed, impG0_..., reduced_density_matrix*.dat
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .config import EDConfig
from .gf import GFResult, GFSpectrum


# ---------------------------------------------------------------------------
# splot-style writers (SF_IOTOOLS splot: x, Re f, Im f columns)
# ---------------------------------------------------------------------------

def splot(path: str, x: np.ndarray, f: np.ndarray) -> None:
    """3-column text format (x, Im f, Re f) — matches SciFortran splot for
    complex arrays (imaginary part first, reference convention)."""
    with open(path, "w") as fh:
        for xi, fi in zip(x, f):
            fh.write(f"{xi:26.18e} {fi.imag:26.18e} {fi.real:26.18e}\n")


def sread(path: str) -> Tuple[np.ndarray, np.ndarray]:
    data = np.loadtxt(path)
    return data[:, 0], data[:, 2] + 1j * data[:, 1]


def _component_suffix(ilat: int, jlat: int, iorb: int, jorb: int,
                      ispin: int) -> str:
    """Reference file suffix (ED_IO.f90:372): 1-based indices, sites
    zero-padded to 4 digits."""
    return (f"_Isite{ilat+1:04d}_Jsite{jlat+1:04d}"
            f"_l{iorb+1}{jorb+1}_s{ispin+1}")


def _print_function(cfg: EDConfig, arr: np.ndarray, x: np.ndarray,
                    prefix: str, axis_tag: str) -> None:
    for ispin in range(cfg.nspin):
        for ilat in range(cfg.nlat):
            for jlat in range(cfg.nlat):
                for iorb in range(cfg.norb):
                    for jorb in range(cfg.norb):
                        sfx = _component_suffix(ilat, jlat, iorb, jorb,
                                                ispin)
                        fn = (prefix + sfx + "_" + axis_tag
                              + cfg.ed_file_suffix + ".ed")
                        splot(os.path.join(cfg.work_dir, fn), x,
                              arr[ilat, jlat, ispin, ispin, iorb, jorb])


def print_impsigma(cfg: EDConfig, gf: GFResult) -> None:
    """ed_print_impSigma (ED_IO.f90:358-380)."""
    _print_function(cfg, gf.smats, gf.wm, "impSigma", "iw")
    _print_function(cfg, gf.sreal, gf.wr, "impSigma", "realw")


def print_impg(cfg: EDConfig, gf: GFResult) -> None:
    _print_function(cfg, gf.gmats, gf.wm, "impG", "iw")
    _print_function(cfg, gf.greal, gf.wr, "impG", "realw")


def print_impg0(cfg: EDConfig, gf: GFResult) -> None:
    _print_function(cfg, gf.g0mats, gf.wm, "impG0", "iw")
    _print_function(cfg, gf.g0real, gf.wr, "impG0", "realw")


def _read_function(cfg: EDConfig,
                   prefix: str) -> Tuple[np.ndarray, np.ndarray]:
    """sread loop over all components for one printed function family
    (ed_read_impSigma_single / ed_read_impG_single, ED_IO.f90:630-744)."""
    fm = np.zeros((cfg.nlat, cfg.nlat, cfg.nspin, cfg.nspin, cfg.norb,
                   cfg.norb, cfg.lmats), np.complex128)
    fr = np.zeros(fm.shape[:-1] + (cfg.lreal,), np.complex128)
    for ispin in range(cfg.nspin):
        for ilat in range(cfg.nlat):
            for jlat in range(cfg.nlat):
                for iorb in range(cfg.norb):
                    for jorb in range(cfg.norb):
                        sfx = _component_suffix(ilat, jlat, iorb, jorb,
                                                ispin)
                        base = os.path.join(cfg.work_dir, prefix + sfx)
                        f_iw = base + "_iw" + cfg.ed_file_suffix + ".ed"
                        f_re = base + "_realw" + cfg.ed_file_suffix + ".ed"
                        if os.path.exists(f_iw):
                            _, v = sread(f_iw)
                            n = min(len(v), cfg.lmats)
                            fm[ilat, jlat, ispin, ispin, iorb, jorb,
                               :n] = v[:n]
                        if os.path.exists(f_re):
                            _, v = sread(f_re)
                            n = min(len(v), cfg.lreal)
                            fr[ilat, jlat, ispin, ispin, iorb, jorb,
                               :n] = v[:n]
    return fm, fr


def read_impsigma(cfg: EDConfig) -> Tuple[np.ndarray, np.ndarray]:
    """ed_read_impSigma (ED_IO.f90:626-659): returns (smats, sreal)."""
    return _read_function(cfg, "impSigma")


def read_impg(cfg: EDConfig) -> Tuple[np.ndarray, np.ndarray]:
    """ed_read_impG (ED_IO.f90:689-717): returns (gmats, greal) — the
    restart-from-G counterpart of :func:`read_impsigma`."""
    return _read_function(cfg, "impG")


def _read_function_lattice(cfg: EDConfig, prefix: str, nineq: int):
    """[Nineq, ...] reader (ed_read_impSigma_lattice / ed_read_impG_lattice,
    ED_IO.f90:661-687,719-744): per-site files carry the reference
    ``_ineq`` + 4-digit-padded suffix (ED_VARS_GLOBAL.f90:278-279)."""
    fm = np.zeros((nineq, cfg.nlat, cfg.nlat, cfg.nspin, cfg.nspin,
                   cfg.norb, cfg.norb, cfg.lmats), np.complex128)
    fr = np.zeros(fm.shape[:-1] + (cfg.lreal,), np.complex128)
    saved = cfg.ed_file_suffix
    try:
        for ineq in range(nineq):
            cfg.ed_file_suffix = f"_ineq{ineq + 1:04d}"
            fm[ineq], fr[ineq] = _read_function(cfg, prefix)
    finally:
        cfg.ed_file_suffix = saved
    return fm, fr


def read_impsigma_lattice(cfg: EDConfig, nineq: int):
    return _read_function_lattice(cfg, "impSigma", nineq)


def read_impg_lattice(cfg: EDConfig, nineq: int):
    return _read_function_lattice(cfg, "impG", nineq)


# ---------------------------------------------------------------------------
# observables files (write_observables, ED_OBSERVABLES.f90:969-1088)
# ---------------------------------------------------------------------------

def _f159(vals, sep=" "):
    """Fortran "90(F15.9,1X)" / "90F15.9" row."""
    return sep.join(f"{float(x):15.9f}" for x in vals)


def _legend(names):
    """Reference legend line: "#" + right-justified A10 names + 6 spaces
    (write_legend "(A1,90(A10,6X))", ED_OBSERVABLES.f90:966-980)."""
    return "#" + "".join(f"{n:>10s}      " for n in names).rstrip() + "\n"


def write_observables(cfg: EDConfig, obs, egs: float,
                      suffix: str = "") -> None:
    """Reference-parity observables file set (write_legend +
    write_observables, ED_OBSERVABLES.f90:966-1088): per-site
    observables_all/last_site###.ed with the full column layout
    [dens docc nup ndw mag | s2 egs | sz2_ab | n2_ab], the
    observables_info.ed / parameters_info.ed legends, parameters_last.ed,
    and the Sz_ij_ab/N2_ij_ab full-tensor files.  Reference-tooling
    consumers of these files parse columns by position."""
    norb, nlat = cfg.norb, cfg.nlat
    wd = cfg.work_dir

    path_info = os.path.join(wd, "observables_info.ed")
    if not os.path.exists(path_info):
        names = []
        k = 0
        for base in ("dens_", "docc_", "nup_", "ndw_", "mag_"):
            for io_ in range(1, norb + 1):
                k += 1
                names.append(f"{k}{base}{io_}")
        names.append(f"{k + 1}s2")
        names.append(f"{k + 2}egs")
        k += 2
        for pre in ("sz2_", "n2_"):
            for io_ in range(1, norb + 1):
                for jo in range(1, norb + 1):
                    k += 1
                    names.append(f"{k}{pre}{io_}{jo}")
        with open(path_info, "w") as fh:
            fh.write(_legend(names))
    path_pinfo = os.path.join(wd, "parameters_info.ed")
    if not os.path.exists(path_pinfo):
        names = ["1xmu", "2beta"] + \
            [f"{2 + i}U_{i}" for i in range(1, norb + 1)] + \
            [f"{2 + norb + 1}U'", f"{2 + norb + 2}Jh"]
        with open(path_pinfo, "w") as fh:
            fh.write("#" + "".join(f"{n:>14s} " for n in names).rstrip()
                     + "\n")

    uloc = cfg.uloc_arr
    for il in range(nlat):
        row = np.concatenate([
            obs.dens[il], obs.docc[il], obs.dens_up[il], obs.dens_dw[il],
            obs.magz[il], [obs.s2tot[il], egs],
            obs.sz2[il, il].ravel(), obs.n2[il, il].ravel()])
        line = _f159(row) + "\n"
        site = f"_site{il + 1:03d}.ed"
        with open(os.path.join(
                wd, f"observables_all{suffix}{site}"), "a") as fh:
            fh.write(line)
        with open(os.path.join(
                wd, f"observables_last{suffix}{site}"), "w") as fh:
            fh.write(line)
    with open(os.path.join(wd, f"parameters_last{suffix}.ed"), "w") as fh:
        fh.write(_f159([cfg.xmu, cfg.beta, *uloc, cfg.ust, cfg.jh,
                        cfg.jx, cfg.jp], sep="") + "\n")
    for name, tens in (("Sz_ij_ab", obs.sz2), ("N2_ij_ab", obs.n2)):
        with open(os.path.join(wd, f"{name}_last{suffix}.ed"), "w") as fh:
            fh.write(f"#I, J, a, b, {name.split('_')[0]}(I,J,a,b)\n")
            for il in range(nlat):
                for jl in range(nlat):
                    for io_ in range(norb):
                        for jo in range(norb):
                            fh.write(f"{il + 1:15d}{jl + 1:15d}"
                                     f"{io_ + 1:15d}{jo + 1:15d}"
                                     f"{tens[il, jl, io_, jo]:15.9f}\n")


def write_zeta_and_sig(cfg: EDConfig, smats_nnn: np.ndarray) -> None:
    """Quasiparticle weight z and scattering rate files
    (ED_GREENS_FUNCTIONS.f90:114-169: zeta_*.ed, sig_*.ed)."""
    from .postprocess import quasiparticle_weight, scattering_rate
    z = quasiparticle_weight(cfg, smats_nnn)
    sig = scattering_rate(cfg, smats_nnn)
    with open(os.path.join(cfg.work_dir,
                           "zeta_last" + cfg.ed_file_suffix + ".ed"),
              "w") as fh:
        fh.write(" ".join(f"{x:24.15e}" for x in z) + "\n")
    with open(os.path.join(cfg.work_dir,
                           "sig_last" + cfg.ed_file_suffix + ".ed"),
              "w") as fh:
        fh.write(" ".join(f"{x:24.15e}" for x in sig) + "\n")


def print_cluster_dm(cfg: EDConfig, cdm: np.ndarray) -> None:
    """Full cluster density-matrix printer (ed_print_dm, ED_IO.f90:457-547)."""
    path = os.path.join(cfg.work_dir,
                        "cluster_density_matrix" + cfg.ed_file_suffix
                        + ".dat")
    np.savetxt(path, np.column_stack([cdm.real.ravel(), cdm.imag.ravel()]))


def write_energy(cfg: EDConfig, energy) -> None:
    """Reference column set (write_energy_info + write_energy,
    ED_OBSERVABLES.f90:1002-1017,1112-1117):
    energy_info.ed legend + energy_last.ed row
    [<Hi>=Epot, <V>=Epot-Ehf, <Eloc>=Eknot, <Ehf>, <Dst>, <Dnd>]."""
    path_info = os.path.join(cfg.work_dir, "energy_info.ed")
    if not os.path.exists(path_info):
        names = ["1<Hi>", "2<V>=<Hi-Ehf>", "3<Eloc>", "4<Ehf>", "5<Dst>",
                 "6<Dnd>"]
        with open(path_info, "w") as fh:
            fh.write("#" + "".join(f"{n:>14s} " for n in names).rstrip()
                     + "\n")
    suffix = cfg.ed_file_suffix
    with open(os.path.join(cfg.work_dir,
                           f"energy_last{suffix}.ed"), "w") as fh:
        fh.write(_f159([energy.epot, energy.epot - energy.ehartree,
                        energy.eknot, energy.ehartree, energy.dust,
                        energy.dund], sep="") + "\n")


# ---------------------------------------------------------------------------
# reduced density matrices (ED_IO/get_reduced_dm.f90:68-212)
# ---------------------------------------------------------------------------

def get_reduced_dm(cfg: EDConfig, cdm: np.ndarray,
                   orbital_mask: np.ndarray) -> np.ndarray:
    """Trace the cluster DM down to the orbitals selected by
    ``orbital_mask`` [Nlat, Norb] (True = keep), with fermionic reordering
    signs (get_sign, get_reduced_dm.f90:168-189).  Vectorised over all
    (iup, idw, jup, jdw) labels at once."""
    nimp = cfg.nimp
    mask = np.asarray(orbital_mask, dtype=bool).ravel()   # level order
    red = np.nonzero(mask)[0]
    tr = np.nonzero(~mask)[0]
    nred = len(red)
    if nred == 0:
        raise ValueError("reduced system needs at least one orbital")
    if nred == nimp:
        return cdm.copy()

    n_full = 1 << nimp
    labels = np.arange(n_full)
    bits = (labels[:, None] >> np.arange(nimp)[None, :]) & 1   # [2^Nimp, Nimp]
    # reduced / traced sub-labels
    red_state = (bits[:, red] << np.arange(nred)).sum(axis=1)
    tr_state = (bits[:, tr] << np.arange(len(tr))).sum(axis=1)
    # fermionic sign: for each kept index r, count traced bits below r
    filt = bits.copy()
    filt[:, red] = 0
    csum = np.cumsum(filt, axis=1)         # inclusive prefix sums
    nswaps = np.zeros(n_full, dtype=np.int64)
    for r in red:
        nswaps += csum[:, r] - filt[:, r]  # strictly-below sum + own bit 0
    # reference get_sign sums filtered(1:indices(r)) INCLUSIVE of r, but
    # filtered(r)=0 for kept indices, so inclusive == exclusive here
    sign = np.where(nswaps & 1 == 1, -1.0, 1.0)

    n_red = 1 << nred
    rdm = np.zeros((n_red * n_red, n_red * n_red), np.complex128)
    # composite cluster index io = Iup + 2^Nimp * Idw (up fastest), so a
    # C-order reshape gives [Idw, Iup] per axis pair; reduced likewise
    cdm4 = cdm.reshape(n_full, n_full, n_full, n_full)   # [idw, iup, jdw, jup]
    for iup in range(n_full):
        jups = np.nonzero(tr_state == tr_state[iup])[0]
        for jup in jups:
            s_up = sign[iup] * sign[jup]
            ru_i, ru_j = red_state[iup], red_state[jup]
            # vectorised over (idw, jdw) with matching traced dw labels
            for idw in range(n_full):
                jdws = np.nonzero(tr_state == tr_state[idw])[0]
                s = s_up * sign[idw] * sign[jdws]
                io = ru_i + n_red * red_state[idw]
                jo = ru_j + n_red * red_state[jdws]
                rdm[io, jo] += s * cdm4[idw, iup, jdws, jup]
    return rdm


def print_reduced_dm(cfg: EDConfig, rdm: np.ndarray,
                     orbital_mask: np.ndarray) -> None:
    mask = np.asarray(orbital_mask, dtype=bool)
    sfx = ""
    for il in range(cfg.nlat):
        for io in range(cfg.norb):
            if mask[il, io]:
                sfx += f"_i{il+1}l{io+1}"
    path = os.path.join(cfg.work_dir,
                        f"reduced_density_matrix{sfx}.dat")
    np.savetxt(path, np.column_stack([rdm.real.ravel(), rdm.imag.ravel()]))


# ---------------------------------------------------------------------------
# GFmatrix (pole/weight) serialization (save/read_gfprime,
# ED_AUX_FUNX.f90:361-584)
# ---------------------------------------------------------------------------

def save_gfmatrix(cfg: EDConfig, spec: GFSpectrum, path: str) -> None:
    """Plain-text serialization of the pole/weight spectrum."""
    with open(path, "w") as fh:
        if getattr(spec, "symmetric", None) is not None:
            fh.write(f"# symmetric {int(spec.symmetric)}\n")
        for key, states in sorted(spec.data.items()):
            for istate, chans in enumerate(states):
                for ichan, ch in enumerate(chans):
                    for p, w in zip(ch.poles, ch.weights):
                        fh.write(f"{key[0]} {key[1]} {key[2]} {key[3]} "
                                 f"{key[4]} {istate} {ichan} "
                                 f"{p:26.18e} {w.real:26.18e} "
                                 f"{w.imag:26.18e}\n")


def read_gfmatrix(path: str) -> GFSpectrum:
    from .gf import GFChannel
    spec = GFSpectrum()
    raw = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("# symmetric"):
                spec.symmetric = bool(int(line.split()[-1]))
                continue
            t = line.split()
            if len(t) != 10:
                continue
            key = tuple(int(x) for x in t[:5])
            istate, ichan = int(t[5]), int(t[6])
            raw.setdefault((key, istate, ichan), []).append(
                (float(t[7]), float(t[8]) + 1j * float(t[9])))
    for (key, istate, ichan), pw in sorted(raw.items()):
        poles = np.array([x[0] for x in pw])
        weights = np.array([x[1] for x in pw])
        spec.add_channel(key, istate, GFChannel(poles, weights))
    return spec
