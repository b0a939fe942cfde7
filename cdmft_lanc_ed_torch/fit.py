"""chi^2 bath fit: conjugate-gradient optimisation of the bath parameters.

Port of the JAX package's ``fit.py`` (ED_FIT_CHI2.f90 + ED_FIT_REPLICA.f90
+ ED_FIT_GENERAL.f90 semantics).  chi^2, including the batched
frequency-dependent inversions inside Delta/G0and, is one torch function on
the device; its gradient comes from ``torch.autograd`` (the JAX package
uses ``jax.value_and_grad``), and scipy's CG drives the host loop.

Reference semantics kept: fit target ``cg_scheme`` "delta" | "weiss",
frequency weights ``cg_weight`` 1 | n | w_n, norm ``cg_norm``
"elemental" (with ``cg_matrix`` element weights) | "frobenius", and the
parameter layout per replica [V (1 value for replica, Nlso for general),
lambda(1..Nsym)] (the bath array minus its N_dec header).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .bath import BathBasis, DmftBath, basis_lso_of, pack_dmft_bath, \
    unpack_dmft_bath
from .config import EDConfig
from .device import resolve_device
from .utils.reshape import lso2nnn, nnn2lso


def _fit_weights(cfg: EDConfig, ldelta: int) -> np.ndarray:
    """Wdelta (ED_FIT_REPLICA.f90:107-114)."""
    xdelta = np.pi / cfg.beta * (2 * np.arange(1, ldelta + 1) - 1)
    if cfg.cg_weight == 2:
        return np.arange(1, ldelta + 1, dtype=np.float64)
    if cfg.cg_weight == 3:
        return xdelta
    return np.ones(ldelta)


def _make_chi2(cfg: EDConfig, basis_lso: torch.Tensor,
               hloc_lso: Optional[torch.Tensor], fg_lso: torch.Tensor,
               z: torch.Tensor, wdelta: torch.Tensor, wmat: torch.Tensor):
    """(model(x), chi2(x)) with x the flat fit-parameter vector."""
    nbath, nlso, nsym = cfg.nbath, cfg.nlso, basis_lso.shape[0]
    nv = 1 if cfg.bath_type == "replica" else nlso
    ldelta = fg_lso.shape[0]
    pow_ = cfg.cg_pow
    ctype = torch.complex128
    eye = torch.eye(nlso, dtype=ctype, device=z.device)

    def model(x):
        x = x.reshape(nbath, nv + nsym)
        v, lam = x[:, :nv], x[:, nv:]
        if cfg.bath_type == "replica":
            v = v.repeat_interleave(nlso, dim=1)
        hk = torch.einsum("bs,sij->bij", lam.to(ctype), basis_lso)
        a = z[:, None, None, None] * eye - hk[None]
        vk = torch.diag_embed(v.to(ctype))
        sol = torch.linalg.solve(a, vk.expand(a.shape))
        delta = torch.einsum("bik,lbkj->lij", vk, sol)
        if cfg.cg_scheme == "weiss":
            g0inv = (z[:, None, None] + cfg.xmu) * eye \
                - hloc_lso[None] - delta
            return torch.linalg.inv(g0inv)
        return delta

    def chi2(x):
        d = model(x) - fg_lso                        # [L, n, n]
        a2 = d.real ** 2 + d.imag ** 2
        if cfg.cg_norm == "frobenius":
            # (ED_FIT_REPLICA.f90:383-410)
            fr = torch.sqrt(a2.sum(dim=(1, 2)))      # [L]
            return (fr ** pow_ / wdelta).sum() / ldelta / nlso
        # elemental (ED_FIT_REPLICA.f90:330-380)
        mag = a2 if pow_ == 2 else a2 ** (pow_ / 2.0)
        per_elem = (mag / wdelta[:, None, None]).sum(dim=0)   # [n, n]
        return (per_elem / wmat).sum() / ldelta / (nlso * nlso)

    return model, chi2


def chi2_fitgf(cfg: EDConfig, hb: BathBasis, fg_nnn: np.ndarray,
               bath_array, hloc_nnn: Optional[np.ndarray] = None,
               log=lambda s: None, device=None
               ) -> Tuple[np.ndarray, float, int]:
    """ed_chi2_fitgf equivalent (ED_FIT_CHI2.f90:20-29): fit the bath to
    the target ``fg_nnn`` [Nlat,Nlat,Nspin,Nspin,Norb,Norb,L] on the
    Matsubara axis; returns (new bath array, chi2, iterations)."""
    device = resolve_device(device)
    nlat, nspin, norb, nlso = cfg.nlat, cfg.nspin, cfg.norb, cfg.nlso
    bath = unpack_dmft_bath(cfg, bath_array)
    nsym = bath.nsym
    ldelta = min(cfg.lfit, fg_nnn.shape[-1])

    fg_lso = np.ascontiguousarray(np.moveaxis(
        nnn2lso(fg_nnn, nlat, nspin, norb), -1, 0)[:ldelta])
    wm = np.pi / cfg.beta * (2 * np.arange(ldelta) + 1)

    # element weights (cg_matrix, ED_FIT_REPLICA.f90:352-366)
    if cfg.cg_matrix == 1 and cfg.cg_norm == "elemental":
        wmat_np = np.abs(fg_lso.sum(axis=0)) / cfg.beta
        wmat_np = np.where(wmat_np > 1e-10, wmat_np, 1.0)
    else:
        wmat_np = np.ones((nlso, nlso))

    hloc_lso = None
    if cfg.cg_scheme == "weiss":
        if hloc_nnn is None:
            raise ValueError("cg_scheme='weiss' requires hloc_nnn")
        hloc_lso = torch.as_tensor(np.ascontiguousarray(nnn2lso(
            np.asarray(hloc_nnn, np.complex128), nlat, nspin, norb))
        ).to(device)

    def dev(a):
        return torch.as_tensor(a).to(device)

    model_fn, chi2_fn = _make_chi2(
        cfg, basis_lso_of(cfg, hb, device), hloc_lso, dev(fg_lso),
        dev(1j * wm), dev(_fit_weights(cfg, ldelta)), dev(wmat_np))

    # pack fit parameters (bath array minus N_dec header)
    nv = 1 if cfg.bath_type == "replica" else nlso
    x0 = np.concatenate([
        np.concatenate([bath.v[ib, :nv], bath.lam[ib]])
        for ib in range(cfg.nbath)])

    from scipy.optimize import minimize

    def fun(x):
        xt = dev(np.asarray(x, np.float64)).requires_grad_(True)
        val = chi2_fn(xt)
        (grad,) = torch.autograd.grad(val, xt)
        return float(val.detach()), grad.cpu().numpy()

    def fun_nojac(x):
        with torch.no_grad():
            return float(chi2_fn(dev(np.asarray(x, np.float64))))

    # cg_method/cg_grad (ED_FIT_REPLICA.f90:138-224): the gradient is
    # exact (autodiff), so the numeric-derivative variants are superseded
    if cfg.cg_method not in (0, 1):
        raise ValueError(f"cg_method={cfg.cg_method} not supported "
                         "(reference accepts 0=NR-CG, 1=minimize; "
                         "ED_INPUT_VARS.f90:181)")
    if cfg.cg_grad not in (0, 1):
        raise ValueError(f"cg_grad={cfg.cg_grad} not supported (0|1)")
    if cfg.cg_method == 1 or cfg.cg_grad == 1:
        log("chi2 fit: numeric-gradient request (cg_method="
            f"{cfg.cg_method}, cg_grad={cfg.cg_grad}) superseded by the "
            "exact autodiff gradient")
    options = {"maxiter": cfg.cg_niter, "gtol": cfg.cg_ftol}

    # cg_stop stopping criteria (ED_INPUT_VARS.f90:184):
    #   C1 = |F_{n-1} - F_n| < ftol*(1+F_n)
    #   C2 = ||x_{n-1} - x_n|| < ftol*(1+||x_n||)
    #   0 = C1 AND C2, 1 = C1, 2 = C2 — enforced via callback.
    if cfg.cg_stop not in (0, 1, 2):
        raise ValueError(f"cg_stop={cfg.cg_stop} not supported (0-2)")
    _prev = {"f": None, "x": None}

    def callback(xk):
        fk = fun_nojac(xk)
        fp, xp = _prev["f"], _prev["x"]
        _prev["f"], _prev["x"] = fk, np.asarray(xk).copy()
        if fp is None:
            return
        c1 = abs(fp - fk) < cfg.cg_ftol * (1.0 + abs(fk))
        c2 = (np.linalg.norm(xp - xk)
              < cfg.cg_ftol * (1.0 + np.linalg.norm(xk)))
        if {0: c1 and c2, 1: c1, 2: c2}[cfg.cg_stop]:
            raise StopIteration

    res = minimize(fun, x0, jac=True, method="CG", callback=callback,
                   options=options)
    xfit = res.x
    log(f"chi2 fit: chi2={res.fun:.6e} iter={res.nit} "
        f"converged={res.success}")

    xr = xfit.reshape(cfg.nbath, nv + nsym)
    vfit = np.zeros_like(bath.v)
    vfit[:, :] = xr[:, :1] if cfg.bath_type == "replica" else xr[:, :nv]
    out = pack_dmft_bath(cfg, DmftBath(v=vfit, lam=xr[:, nv:].copy()))

    # result files (ED_FIT_REPLICA.f90:228-291)
    suffix = "_ALLorb_ALLspins" + cfg.ed_file_suffix
    try:
        with open(os.path.join(cfg.work_dir,
                               "chi2fit_results" + suffix + ".ed"),
                  "a") as fh:
            fh.write(f"{res.fun:18.9e} {res.nit:5d}\n")
    except OSError:
        pass
    with torch.no_grad():
        fgand_lso = model_fn(dev(xfit)).cpu().numpy()
    _write_fit_result(cfg, fgand_lso, fg_lso, wm)
    return out, float(res.fun), int(res.nit)


def _write_fit_result(cfg: EDConfig, fgand_lso: np.ndarray,
                      fg_lso: np.ndarray, wm: np.ndarray) -> None:
    """fit_weiss/fit_delta per-component files (write_fit_result,
    ED_FIT_REPLICA.f90:249-291): columns ``w  Im fg  Im fgand  Re fg
    Re fgand`` on the fit grid."""
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    fg_nnn = lso2nnn(np.moveaxis(fg_lso, 0, -1), nlat, nspin, norb)
    fgand_nnn = lso2nnn(np.moveaxis(fgand_lso, 0, -1), nlat, nspin, norb)
    stem = "fit_weiss" if cfg.cg_scheme == "weiss" else "fit_delta"
    for ilat in range(nlat):
        for jlat in range(nlat):
            for ispin in range(nspin):
                for jspin in range(nspin):
                    for iorb in range(norb):
                        for jorb in range(norb):
                            name = (f"{stem}_i{ilat+1}_j{jlat+1}"
                                    f"_l{iorb+1}_m{jorb+1}"
                                    f"_s{ispin+1}_r{jspin+1}"
                                    f"{cfg.ed_file_suffix}.ed")
                            a = fg_nnn[ilat, jlat, ispin, jspin,
                                       iorb, jorb]
                            b = fgand_nnn[ilat, jlat, ispin, jspin,
                                          iorb, jorb]
                            try:
                                with open(os.path.join(cfg.work_dir,
                                                       name), "w") as fh:
                                    for i, w in enumerate(wm):
                                        fh.write(
                                            f"{w:24.15f}{a[i].imag:24.15f}"
                                            f"{b[i].imag:24.15f}"
                                            f"{a[i].real:24.15f}"
                                            f"{b[i].real:24.15f}\n")
                            except OSError:
                                return
