"""Observable contractions for large-sector states kept on the card.

Port of the JAX package's ``observables_device.py``: a retained
large-sector eigenvector (1.3 GB in f64 at Ns=16) stays where the solver
left it, and only Nimp-sized results reach the host.

* :func:`density_reductions` gives the densities, the cross-spin and
  same-spin pair averages and <S_z^2> per site from |psi|^2 (the JAX
  package's observables.py:55-109);
* :func:`hop_sums_device` gives <psi| c^+_a c_b |psi> for a list of
  one-body terms as index gathers contracted on the device, in chunks of
  hop entries (the reference applies the operators state by state on its
  master, ED_OBSERVABLES.f90:311-348,594-686);
* :func:`cluster_dm_device` gives rho_IMP = Tr_BATH |psi><psi| by the
  host algorithm of ``observables.cluster_density_matrix`` on device
  tensors: one scatter and one contraction per up-bath configuration
  (ED_OBSERVABLES.f90:514-575).

Vectors are real or complex tensors (the JAX package's real plane or
``SplitVector``); occupation tables go to the device in f64.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils import fock

_CHUNK = 1 << 10        # hop entries per gather


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64)).to(device)


def density_reductions(v2d: torch.Tensor, n_up, n_dw, sz_up, sz_dw):
    """(pu [Nimp], pd [Nimp], cross [Nimp, Nimp], uu, dd, s2 [Nlat]) of
    one state v2d [DimDw, DimUp] on its device, as host arrays:
    pu/pd the spin densities, cross[b, a] = <n_dw,b n_up,a>, uu/dd the
    same-spin pair averages and s2 the <(S_z,up + S_z,dw)^2> per site
    from the per-factor S_z tables ``sz_up`` [DimUp, Nlat] and ``sz_dw``
    [DimDw, Nlat]."""
    dev = v2d.device
    if v2d.is_complex():
        prob = v2d.real * v2d.real + v2d.imag * v2d.imag
    else:
        prob = v2d * v2d
    prob = prob.to(torch.float64)
    n_up, n_dw = _f64(n_up, dev), _f64(n_dw, dev)
    sz_up, sz_dw = _f64(sz_up, dev), _f64(sz_dw, dev)
    pu_m = prob.sum(dim=0)                    # [DimUp]
    pd_m = prob.sum(dim=1)                    # [DimDw]
    pu = pu_m @ n_up
    pd = pd_m @ n_dw
    cross = n_dw.T @ (prob @ n_up)
    uu = torch.einsum("u,ua,ub->ab", pu_m, n_up, n_up)
    dd = torch.einsum("d,da,db->ab", pd_m, n_dw, n_dw)
    s2 = (pu_m @ (sz_up * sz_up)
          + 2.0 * ((prob @ sz_up) * sz_dw).sum(dim=0)
          + pd_m @ (sz_dw * sz_dw))
    return tuple(t.cpu().numpy() for t in (pu, pd, cross, uu, dd, s2))


def hop_sums_device(vec: torch.Tensor, shape2d, pair_list, states,
                    axis: int) -> np.ndarray:
    """<psi| sum_k w_k c^+_a c_b |psi> per (a, b, amp) of ``pair_list``
    on a device state, the amplitude folded into the weights.  The terms
    act on the spin factor addressed by ``axis`` (1 = up: columns of the
    [DimDw, DimUp] state; 0 = dw: rows), whose Fock states are
    ``states``.  Returns host complex [P]."""
    v2d = vec.reshape(shape2d)
    if axis == 0:
        v2d = v2d.T                           # the factor on columns
    out = np.zeros(len(pair_list), np.complex128)
    for p, (a, b, amp) in enumerate(pair_list):
        rows, cols, signs = fock.hop_entries(states, a, b)
        acc = torch.zeros((), dtype=torch.complex128, device=v2d.device)
        for c0 in range(0, len(rows), _CHUNK):
            sl = slice(c0, c0 + _CHUNK)
            r = torch.as_tensor(rows[sl], device=v2d.device)
            c = torch.as_tensor(cols[sl], device=v2d.device)
            w = _f64(signs[sl], v2d.device)
            vr = v2d.index_select(1, r)
            vc = v2d.index_select(1, c)
            acc = acc + ((vr.conj() * vc).sum(dim=0) * w).sum()
        out[p] = complex(amp) * complex(acc.cpu())
    return out


def cluster_dm_device(vec: torch.Tensor, shape2d, nimp: int, states_up,
                      states_dw) -> np.ndarray:
    """Tr_BATH |psi><psi| [4^Nimp, 4^Nimp] of a device state (composite
    label IimpUp + 2^Nimp * IimpDw, ED_OBSERVABLES.f90:559-561).  Sector
    states are grouped by their up-bath configuration; each group's
    columns are scattered into X[imp_dw, bath_dw, imp_up] and contracted
    over the down-bath label.  Returns a host array."""
    dev = vec.device
    v2d = vec.reshape(shape2d).to(torch.complex128)
    dim_imp = 1 << nimp
    d2 = dim_imp * dim_imp
    mask = (1 << nimp) - 1
    imp_up = (states_up & mask).astype(np.int64)
    bath_up = (states_up >> nimp).astype(np.int64)
    imp_dw = (states_dw & mask).astype(np.int64)
    bath_dw = (states_dw >> nimp).astype(np.int64)
    _, ub_inv = np.unique(bath_up, return_inverse=True)
    db_vals, db_inv = np.unique(bath_dw, return_inverse=True)
    n_db = len(db_vals)
    rho = torch.zeros((d2, d2), dtype=torch.complex128, device=dev)
    order = np.argsort(ub_inv, kind="stable")
    bounds = np.searchsorted(ub_inv[order], np.arange(ub_inv.max() + 2))
    row_id = torch.as_tensor(imp_dw, device=dev)
    row_db = torch.as_tensor(db_inv, device=dev)
    for g in range(len(bounds) - 1):
        cols = order[bounds[g]:bounds[g + 1]]
        m = len(cols)
        x = torch.zeros((dim_imp, n_db, dim_imp), dtype=torch.complex128,
                        device=dev)
        iu = torch.as_tensor(imp_up[cols], device=dev)
        x.index_put_((row_id[:, None].expand(-1, m),
                      row_db[:, None].expand(-1, m),
                      iu[None, :].expand(len(imp_dw), -1)),
                     v2d[:, torch.as_tensor(cols, device=dev)])
        rho += torch.einsum("dbi,ebj->diej", x, x.conj()).reshape(d2, d2)
    return rho.cpu().numpy()
