"""Bath layer: replica bath parametrisation + analytic bath functions.

Port of the JAX package's ``bath.py`` (replica/general bath storage and the
reference-exact flat bath array layout, ED_BATH/dmft_aux.f90:283-362).
The analytic functions Delta(z), G0and(z), invG0(z)
(ED_BATH_FUNCTIONS.f90:39-155) are batched complex128 linear algebra over
the whole frequency axis on torch tensors, differentiable through
``torch.autograd`` with respect to (V, lambda): the chi^2 bath fit takes
its gradient from them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .config import EDConfig
from .device import resolve_device
from .utils.reshape import lso2nnn, nnn2lso


# ---------------------------------------------------------------------------
# bath basis (Hbath_basis + Hbath_lambda of hbath_setup.f90)
# ---------------------------------------------------------------------------

@dataclass
class BathBasis:
    """Symmetry decomposition of the bath Hamiltonian.

    basis : [Nsym, Nlat, Nlat, Nspin, Nspin, Norb, Norb] complex
    init_lambda : [Nbath, Nsym] float — initial coefficients per replica
    """
    basis: np.ndarray
    init_lambda: np.ndarray

    @property
    def nsym(self) -> int:
        return self.basis.shape[0]

    def build(self, lam: np.ndarray) -> np.ndarray:
        """H_bath = sum_s lam[s] * basis[s] (Hbath_build, hbath_setup.f90:240-250).

        lam may be [Nsym] (one replica) or [Nbath, Nsym] (all replicas)."""
        lam = np.asarray(lam)
        return np.einsum("...s,sabcdef->...abcdef", lam, self.basis)


def set_hbath(basis, lambdas, cfg: EDConfig) -> BathBasis:
    """User API ed_set_Hbath (symmetry variant, hbath_setup.f90:163-233).

    basis : [Nlat,Nlat,Nspin,Nspin,Norb,Norb,Nsym] (reference axis order) or
            [Nsym,Nlat,Nlat,Nspin,Nspin,Norb,Norb]
    lambdas : [Nbath, Nsym] (new behaviour) or [Nsym] (legacy: replicated)
    """
    basis = np.asarray(basis, dtype=np.complex128)
    want = (cfg.nlat, cfg.nlat, cfg.nspin, cfg.nspin, cfg.norb, cfg.norb)
    if basis.shape[:6] == want:                    # reference trailing-Nsym order
        basis = np.moveaxis(basis, -1, 0)
    if basis.shape[1:] != want:
        raise ValueError(f"bath basis shape {basis.shape} incompatible with "
                         f"cluster shape {want}")
    lambdas = np.asarray(lambdas, dtype=np.float64)
    if lambdas.ndim == 1:                          # legacy single-lambda path
        lambdas = np.tile(lambdas, (cfg.nbath, 1))
    if lambdas.shape != (cfg.nbath, basis.shape[0]):
        raise ValueError(f"lambda array shape {lambdas.shape} != "
                         f"({cfg.nbath}, {basis.shape[0]})")
    return BathBasis(basis=basis, init_lambda=lambdas.copy())


def hbath_basis_from_hloc(hloc, cfg: EDConfig) -> BathBasis:
    """ed_set_Hbath direct variant (hbath_setup.f90:34-159): one basis matrix
    per independent nonzero Re/Im entry of the provided Hloc (upper triangle
    in lso indexing), initial lambda = the entry value."""
    hloc = np.asarray(hloc, dtype=np.complex128)
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    basis_list: List[np.ndarray] = []
    lam0: List[float] = []

    def stride(ilat, ispin, iorb):
        return iorb + ilat * norb + ispin * norb * nlat

    for ispin in range(nspin):
        for jspin in range(nspin):
            for ilat in range(nlat):
                for jlat in range(nlat):
                    for iorb in range(norb):
                        for jorb in range(norb):
                            io = stride(ilat, ispin, iorb)
                            jo = stride(jlat, jspin, jorb)
                            if io > jo:
                                continue
                            val = hloc[ilat, jlat, ispin, jspin, iorb, jorb]
                            if val == 0:
                                continue
                            if val.real != 0.0:
                                o = np.zeros_like(hloc)
                                o[ilat, jlat, ispin, jspin, iorb, jorb] = 1.0
                                if io != jo:
                                    o[jlat, ilat, jspin, ispin, jorb, iorb] = 1.0
                                basis_list.append(o)
                                lam0.append(val.real)
                            if val.imag != 0.0:
                                o = np.zeros_like(hloc)
                                o[ilat, jlat, ispin, jspin, iorb, jorb] = 1j
                                if io != jo:
                                    o[jlat, ilat, jspin, ispin, jorb, iorb] = -1j
                                basis_list.append(o)
                                lam0.append(val.imag)
    basis = np.stack(basis_list) if basis_list else \
        np.zeros((0,) + hloc.shape, np.complex128)
    lam = np.tile(np.asarray(lam0), (cfg.nbath, 1))
    return BathBasis(basis=basis, init_lambda=lam)


# ---------------------------------------------------------------------------
# bath parameters + flat user array codec (dmft_aux.f90)
# ---------------------------------------------------------------------------

@dataclass
class DmftBath:
    """Runtime bath parameters (the reference effective_bath).

    v   : [Nbath, Nlso] float — hybridisations (all-equal rows for replica)
    lam : [Nbath, Nsym] float — symmetry coefficients
    """
    v: np.ndarray
    lam: np.ndarray

    @property
    def nbath(self) -> int:
        return self.v.shape[0]

    @property
    def nsym(self) -> int:
        return self.lam.shape[1]


def get_bath_dimension(cfg: EDConfig, nsym: int) -> int:
    """Flat array length (get_bath_dimension_symmetries, user_aux.f90:51-72)."""
    ndx = (nsym + 1) * cfg.nbath
    if cfg.bath_type == "replica":
        ndx += cfg.nbath
    else:
        ndx += cfg.nbath * cfg.nlso
    return ndx


def _host_array(bath_array) -> np.ndarray:
    """Flat bath array (numpy, or a tensor on any device) as host f64."""
    if isinstance(bath_array, torch.Tensor):
        bath_array = bath_array.detach().cpu().numpy()
    return np.asarray(bath_array, dtype=np.float64)


def check_bath_dimension(cfg: EDConfig, nsym: int, bath_array) -> bool:
    return len(_host_array(bath_array)) == get_bath_dimension(cfg, nsym)


def init_dmft_bath(cfg: EDConfig, hb: BathBasis,
                   restart_file: Optional[str] = None) -> DmftBath:
    """Initialize bath parameters (init_dmft_bath, dmft_aux.f90:49-129).

    V = max(0.1, 1/sqrt(Nbath)); lambda from the basis' initial values with
    the legacy rescale patch: if a basis matrix is diagonal AND all replicas
    got the same lambda, rescale by linspace(HWBAND/Nbath, HWBAND, Nbath).
    If ``restart_file`` exists it overrides everything (reference Hfile.restart).
    """
    nbath, nlso, nsym = cfg.nbath, cfg.nlso, hb.nsym
    if nbath == 0:
        return DmftBath(v=np.zeros((0, nlso)), lam=np.zeros((0, 0)))
    v = np.full((nbath, nlso), max(0.1, 1.0 / np.sqrt(nbath)))
    lam = hb.init_lambda.copy()
    if nbath > 1:
        rescale = np.linspace(cfg.hwband / nbath, cfg.hwband, nbath)
    else:
        rescale = np.zeros(1)
    basis_lso = np.stack([nnn2lso(hb.basis[s], cfg.nlat, cfg.nspin, cfg.norb)
                          for s in range(nsym)]) if nsym else \
        np.zeros((0, nlso, nlso), np.complex128)
    for s in range(nsym):
        diagonal = np.allclose(basis_lso[s], np.diag(np.diag(basis_lso[s])))
        all_equal = np.all(lam[:, s] == lam[0, s])
        if diagonal and all_equal:
            lam[:, s] = rescale * lam[:, s]
    bath = DmftBath(v=v, lam=lam)
    if restart_file is not None:
        import os
        if os.path.exists(restart_file):
            bath = read_dmft_bath(cfg, nsym, restart_file)
    return bath


def pack_dmft_bath(cfg: EDConfig, bath: DmftBath) -> np.ndarray:
    """bath -> flat user array (get_dmft_bath, dmft_aux.f90:330-365)."""
    out = [np.full(bath.nbath, float(bath.nsym))]
    for ib in range(bath.nbath):
        if cfg.bath_type == "replica":
            out.append(bath.v[ib, :1])
        else:
            out.append(bath.v[ib])
        out.append(bath.lam[ib])
    return np.concatenate(out)


def unpack_dmft_bath(cfg: EDConfig, bath_array) -> DmftBath:
    """flat user array -> bath (set_dmft_bath, dmft_aux.f90:283-324)."""
    a = _host_array(bath_array)
    nbath, nlso = cfg.nbath, cfg.nlso
    if nbath == 0:
        return DmftBath(v=np.zeros((0, nlso)), lam=np.zeros((0, 0)))
    ndec = np.rint(a[:nbath]).astype(int)
    nsym = int(ndec[0])
    if not np.all(ndec == nsym):
        raise ValueError("inconsistent N_dec entries in bath array")
    v = np.zeros((nbath, nlso))
    lam = np.zeros((nbath, nsym))
    p = nbath
    for ib in range(nbath):
        if cfg.bath_type == "replica":
            v[ib, :] = a[p]
            p += 1
        else:
            v[ib, :] = a[p:p + nlso]
            p += nlso
        lam[ib, :] = a[p:p + nsym]
        p += nsym
    return DmftBath(v=v, lam=lam)


# -- restart text file (write_dmft_bath file branch, dmft_aux.f90:142-196) --

def save_dmft_bath(cfg: EDConfig, bath: DmftBath, path: str) -> None:
    with open(path, "w") as fh:
        for _ in range(bath.nbath):
            fh.write(f"{bath.nsym:3d}\n")
        for ib in range(bath.nbath):
            fh.write(" ".join(f"{x:21.12f}" for x in bath.v[ib]) + "\n")
            fh.write("  " + "  ".join(f"{x:.16g}" for x in bath.lam[ib]) + "\n")


def read_dmft_bath(cfg: EDConfig, nsym: int, path: str) -> DmftBath:
    """Parse the reference restart format (init_dmft_bath read branch,
    dmft_aux.f90:104-129)."""
    nbath, nlso = cfg.nbath, cfg.nlso
    with open(path) as fh:
        lines = [ln for ln in (l.strip() for l in fh) if ln]
    ndec = [int(float(lines[i].split()[0])) for i in range(nbath)]
    v = np.zeros((nbath, nlso))
    lam = np.zeros((nbath, max(ndec)))
    p = nbath
    for ib in range(nbath):
        vals = [float(t) for t in lines[p].split()]
        if cfg.bath_type == "replica":
            v[ib, :] = vals[0]
        else:
            v[ib, :] = vals[:nlso]
        p += 1
        lvals = [float(t) for t in lines[p].split()]
        lam[ib, :ndec[ib]] = lvals[:ndec[ib]]
        p += 1
    return DmftBath(v=v, lam=lam)


# ---------------------------------------------------------------------------
# user symmetry helpers (ED_BATH/user_aux.f90:112-157) + Hbath_mask
# ---------------------------------------------------------------------------

def impose_equal_lambda(cfg: EDConfig, bath_array, ibath: int,
                        lambda_indices) -> np.ndarray:
    """Average the chosen lambda components of replica ``ibath`` (0-based)
    and set them all to the average (impose_equal_lambda,
    user_aux.f90:112-133)."""
    bath = unpack_dmft_bath(cfg, bath_array)
    idx = np.asarray(lambda_indices, dtype=int)
    val = bath.lam[ibath, idx].mean()
    bath.lam[ibath, idx] = val
    return pack_dmft_bath(cfg, bath)


def impose_bath_offset(cfg: EDConfig, bath_array, ibath: int,
                       offset: float) -> np.ndarray:
    """Set the identity-like lambda component of replica ``ibath`` to
    ``offset`` (impose_bath_offset, user_aux.f90:136-157): applied to the
    component whose basis matrix is proportional to the identity."""
    bath = unpack_dmft_bath(cfg, bath_array)
    bath.lam[ibath, -1] = offset
    return pack_dmft_bath(cfg, bath)


def hbath_mask(cfg: EDConfig, hb: BathBasis, wdiag: bool = False,
               uplo: bool = False) -> np.ndarray:
    """Boolean mask of nonzero bath-Hamiltonian components
    (Hbath_mask, ED_BATH/hbath_setup.f90:258-299)."""
    mask = np.zeros((cfg.nlat, cfg.nlat, cfg.nspin, cfg.nspin,
                     cfg.norb, cfg.norb), dtype=bool)
    for s in range(hb.nsym):
        mask |= hb.basis[s] != 0
    if wdiag:
        for il in range(cfg.nlat):
            for sp in range(cfg.nspin):
                for io in range(cfg.norb):
                    mask[il, il, sp, sp, io, io] = True
    if uplo:
        nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
        for il in range(nlat):
            for jl in range(nlat):
                for sp in range(nspin):
                    for so in range(nspin):
                        for io in range(norb):
                            for jo in range(norb):
                                i = io + il * norb + sp * norb * nlat
                                j = jo + jl * norb + so * norb * nlat
                                if i > j:
                                    mask[il, jl, sp, so, io, jo] = False
    return mask


# ---------------------------------------------------------------------------
# pieces consumed by the Hamiltonian builder
# ---------------------------------------------------------------------------

def bath_h_rec(cfg: EDConfig, hb: BathBasis, bath: DmftBath) -> np.ndarray:
    """[Nbath, Nlat,Nlat,Nspin,Nspin,Norb,Norb] reconstructed replica
    Hamiltonians (ED_HAMILTONIAN_SPARSE_HxV.f90:63-75)."""
    return hb.build(bath.lam)


def diag_hybr_of(cfg: EDConfig, bath: DmftBath) -> np.ndarray:
    """[Nlat, Nspin, Norb, Nbath] hybridisation amplitudes: V at the lso
    stride index (ED_HAMILTONIAN_SPARSE_HxV.f90:68-73)."""
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    out = np.zeros((nlat, nspin, norb, cfg.nbath))
    for ilat in range(nlat):
        for ispin in range(nspin):
            for iorb in range(norb):
                io = iorb + ilat * norb + ispin * norb * nlat
                out[ilat, ispin, iorb, :] = bath.v[:, io]
    return out


# ---------------------------------------------------------------------------
# analytic bath functions: batched, differentiable torch
# ---------------------------------------------------------------------------

def basis_lso_of(cfg: EDConfig, hb: BathBasis, device) -> torch.Tensor:
    """[Nsym, Nlso, Nlso] complex128 basis on ``device``."""
    if hb.nsym == 0:
        return torch.zeros((0, cfg.nlso, cfg.nlso), dtype=torch.complex128,
                           device=device)
    arr = np.stack([nnn2lso(hb.basis[s], cfg.nlat, cfg.nspin, cfg.norb)
                    for s in range(hb.nsym)])
    return torch.as_tensor(np.ascontiguousarray(arr)).to(device)


def delta_bath_lso(z: torch.Tensor, v: torch.Tensor, lam: torch.Tensor,
                   basis_lso: torch.Tensor) -> torch.Tensor:
    """Hybridisation function Delta(z) in lso form, batched over z.

    z : [L] complex frequencies (already shifted: i*wn or w+i*eps)
    v : [Nbath, Nlso] real;  lam : [Nbath, Nsym] real
    returns [L, Nlso, Nlso] complex.

    Delta(z) = sum_k V_k (z - H_k)^{-1} V_k with V_k = diag(v[k])
    (delta_bath_array, ED_BATH_FUNCTIONS.f90:70-99), one batched solve
    over (L, Nbath).
    """
    nlso = basis_lso.shape[-1]
    ctype = basis_lso.dtype
    hk = torch.einsum("bs,sij->bij", lam.to(ctype), basis_lso)
    eye = torch.eye(nlso, dtype=ctype, device=basis_lso.device)
    a = z[:, None, None, None] * eye - hk[None]
    vk = torch.diag_embed(v.to(ctype))                       # [B, n, n]
    x = torch.linalg.solve(a, vk.expand(a.shape))            # (z-H)^-1 Vk
    return torch.einsum("bik,lbkj->lij", vk, x)


def invg0_bath_lso(z: torch.Tensor, hloc_lso: torch.Tensor, xmu: float,
                   v: torch.Tensor, lam: torch.Tensor,
                   basis_lso: torch.Tensor) -> torch.Tensor:
    """G0^{-1}(z) = (z+mu) I - Hloc - Delta(z)  [L, Nlso, Nlso]
    (invg0_bath_array, ED_BATH_FUNCTIONS.f90:140-155)."""
    nlso = hloc_lso.shape[-1]
    eye = torch.eye(nlso, dtype=torch.complex128, device=hloc_lso.device)
    delta = delta_bath_lso(z, v, lam, basis_lso)
    return (z[:, None, None] + xmu) * eye - hloc_lso[None] - delta


def g0and_bath_lso(z: torch.Tensor, hloc_lso: torch.Tensor, xmu: float,
                   v: torch.Tensor, lam: torch.Tensor,
                   basis_lso: torch.Tensor) -> torch.Tensor:
    """Andersen non-interacting G0(z) = [invG0(z)]^{-1}  [L, Nlso, Nlso]
    (g0and_bath, ED_BATH_FUNCTIONS.f90:102-121)."""
    return torch.linalg.inv(invg0_bath_lso(z, hloc_lso, xmu, v, lam,
                                           basis_lso))


# nnn-shaped wrappers (reference array shape [Nlat,Nlat,Nspin,Nspin,
# Norb,Norb,L]); host numpy in and out, device work in between
# (``device=None`` is the card)

def _nnn_of(cfg: EDConfig, g_lso: torch.Tensor) -> np.ndarray:
    g = np.moveaxis(g_lso.detach().cpu().numpy(), 0, -1)
    return lso2nnn(g, cfg.nlat, cfg.nspin, cfg.norb)


def _dev_args(cfg, hb, bath, z, device):
    dev = resolve_device(device)
    return (torch.as_tensor(np.asarray(z, np.complex128)).to(dev),
            torch.as_tensor(bath.v).to(dev),
            torch.as_tensor(bath.lam).to(dev), basis_lso_of(cfg, hb, dev))


def _hloc_lso(cfg, hloc_nnn, device) -> torch.Tensor:
    h = nnn2lso(np.asarray(hloc_nnn, np.complex128), cfg.nlat, cfg.nspin,
                cfg.norb)
    return torch.as_tensor(np.ascontiguousarray(h)).to(device)


def delta_bath(cfg: EDConfig, hb: BathBasis, bath: DmftBath,
               z: np.ndarray, device=None) -> np.ndarray:
    zt, v, lam, basis = _dev_args(cfg, hb, bath, z, device)
    return _nnn_of(cfg, delta_bath_lso(zt, v, lam, basis))


def g0and_bath(cfg: EDConfig, hb: BathBasis, bath: DmftBath,
               hloc_nnn: np.ndarray, z: np.ndarray,
               device=None) -> np.ndarray:
    zt, v, lam, basis = _dev_args(cfg, hb, bath, z, device)
    return _nnn_of(cfg, g0and_bath_lso(
        zt, _hloc_lso(cfg, hloc_nnn, zt.device), cfg.xmu, v, lam, basis))


def invg0_bath(cfg: EDConfig, hb: BathBasis, bath: DmftBath,
               hloc_nnn: np.ndarray, z: np.ndarray,
               device=None) -> np.ndarray:
    zt, v, lam, basis = _dev_args(cfg, hb, bath, z, device)
    return _nnn_of(cfg, invg0_bath_lso(
        zt, _hloc_lso(cfg, hloc_nnn, zt.device), cfg.xmu, v, lam, basis))
