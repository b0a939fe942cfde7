"""Sharded sector H·v: the all-to-all transpose, and the dense-factor
sharded matvecs.

Port of the JAX package's ``parallel/sharded_spmv.py``.  The sector
vector, viewed as the matrix x [DimDw, DimUp], is sharded along dw over
the ranks of the mesh's "dw" axis: each rank holds x_loc [dw_loc, DimUp].

* X·H_upᵀ (and the diagonal) is local on every rank;
* H_dw·X needs the dw axis: one ``all_to_all_single`` transposes the
  vector to [DimDw, up_loc], the product runs there, and a second one
  transposes back (:func:`to_dw_major`, :func:`to_up_major`);
* the Jx/Jp Kronecker terms fold into the same two exchanges (the up
  factor is applied before the transpose, the dw factor while
  transposed).

Complex tensors are exchanged as their (re, im) real views.  Over a
one-rank gloo group (a "dw" axis of size 1 where gloo carries the mesh)
nothing is exchanged: gloo would stage the CUDA tensor through the host
and hand back its input (:func:`exchange_group`); a one-rank NCCL group
keeps its collectives, which are copies on the card.  The module
counts the exchanges this process made (``exchanges``), the bytes it sent
to other ranks (``exchange_bytes``) and, when ``timing`` is set, their
seconds (:func:`exchange_seconds`: CUDA events on the card, the host
clock on the CPU).  The dense-factor matvecs keep their local products
as ``torch.matmul``, as the JAX functions compute them outside any
Pallas kernel; ``ops/spmv.py``'s ELL form (``make_sharded_matvec``,
``pad_device_op``, ``shard_local_kernel``) is left out of the port.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.sector_ham import SectorOperator
from ..ops.split import op_is_real
from . import multichip

exchanges = 0          # all-to-alls made by this process
exchange_bytes = 0     # bytes this process sent to other ranks
timing = False         # record each exchange's time (exchange_seconds)
_spans = []            # (start, end) CUDA events or host times


def reset_counters() -> None:
    global exchanges, exchange_bytes
    exchanges = exchange_bytes = 0
    _spans.clear()


def exchange_seconds() -> float:
    """Seconds spent in the exchanges recorded while ``timing`` was set
    (synchronises the card)."""
    total = 0.0
    for a, b in _spans:
        if isinstance(a, float):
            total += b - a
        else:
            b.synchronize()
            total += a.elapsed_time(b) / 1e3
    return total


def exchange_group(group):
    """``group``, or None where a collective over it only returns its
    input through the host: a one-rank gloo group."""
    if group is not None and dist.get_world_size(group) == 1 \
            and dist.get_backend(group) == "gloo":
        return None
    return group


def _real_view(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def all_to_all(send: torch.Tensor, group, ndw: int, async_op=False):
    """``send`` [ndw, ...] contiguous: chunk i goes to rank i of
    ``group``; returns the received [ndw, ...] (chunk i from rank i), or
    (received, work) with ``async_op``.  Without a group (one rank) the
    chunk is its own."""
    global exchanges, exchange_bytes
    if group is None:
        return (send, _Done()) if async_op else send
    recv = torch.empty_like(send)
    span = None
    if timing and not async_op:
        if send.is_cuda:
            span = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            span[0].record()
        else:
            span = [time.perf_counter(), 0.0]
    work = dist.all_to_all_single(_real_view(recv), _real_view(send),
                                  group=group, async_op=async_op)
    if span is not None:
        if send.is_cuda:
            span[1].record()
        else:
            span[1] = time.perf_counter()
        _spans.append(tuple(span))
    exchanges += 1
    exchange_bytes += send.numel() * send.element_size() * (ndw - 1) // ndw
    return (recv, work) if async_op else recv


class _Done:
    """The finished work of an exchange that needed none."""

    def wait(self):
        return True


def to_dw_major(p: torch.Tensor, group, ndw: int) -> torch.Tensor:
    """[..., dw_loc, up] rows of this rank -> [..., dw_loc·ndw, up_loc]:
    every dw row, this rank's slice of the up columns."""
    *lead, dwl, up = p.shape
    upl = up // ndw
    c = int(np.prod(lead, dtype=np.int64))
    send = p.reshape(c, dwl, ndw, upl).permute(2, 0, 1, 3).contiguous()
    recv = all_to_all(send, group, ndw)          # chunk i: rank i's rows
    return recv.permute(1, 0, 2, 3).reshape(*lead, ndw * dwl, upl)


def to_up_major(y: torch.Tensor, group, ndw: int) -> torch.Tensor:
    """The inverse of :func:`to_dw_major`: [..., dw, up_loc] ->
    [..., dw_loc, up_loc·ndw]."""
    *lead, dw, upl = y.shape
    dwl = dw // ndw
    c = int(np.prod(lead, dtype=np.int64))
    send = y.reshape(c, ndw, dwl, upl).permute(1, 0, 2, 3).contiguous()
    recv = all_to_all(send, group, ndw)          # chunk j: rank j's columns
    return recv.permute(1, 2, 0, 3).reshape(*lead, dwl, ndw * upl)


def gather_rows(x: torch.Tensor, group, ndw: int) -> torch.Tensor:
    """[c, dw_loc, up] rows of every rank, concatenated: [c, dw, up]."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ndw)]
    dist.all_gather([_real_view(t) for t in parts], _real_view(x),
                    group=group)
    return torch.cat(parts, dim=1)


def _padded(a: np.ndarray, r: int, c: int) -> np.ndarray:
    out = np.zeros((r, c), a.dtype)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _dense_factors(op: SectorOperator, ndw: int, complex_: bool):
    """(dd, du, diag, hupT, hdw, nd_upT [T, du, du], nd_dw [T, dd, dd],
    amp [T]) padded so ndw divides both dims; padded rows are zero."""
    dd = -(-op.dim_dw // ndw) * ndw
    du = -(-op.dim_up // ndw) * ndw
    hu, hd = op.h_up.to_dense(), op.h_dw.to_dense()
    if not complex_:
        hu, hd = hu.real, hd.real
    t = len(op.nd_terms)
    nd_upT = np.zeros((t, du, du))
    nd_dw = np.zeros((t, dd, dd))
    amp = np.zeros(t, np.complex128)
    for i, term in enumerate(op.nd_terms):
        iu = np.nonzero(term.up_src >= 0)[0]
        nd_upT[i, term.up_src[iu], iu] = term.up_sgn[iu]
        idw = np.nonzero(term.dw_src >= 0)[0]
        nd_dw[i, idw, term.dw_src[idw]] = term.dw_sgn[idw]
        amp[i] = term.amp
    return (dd, du, _padded(op.diag(), dd, du),
            _padded(np.ascontiguousarray(hu.T), du, du),
            _padded(np.ascontiguousarray(hd), dd, dd), nd_upT, nd_dw,
            amp if complex_ else amp.real)


def _make_dense(op: SectorOperator, mesh, axis: str, overlap: int,
                complex_: bool, dtype, device):
    group, ndw, rank = multichip.axis_info(mesh, axis)
    if group is None:
        raise ValueError(f"the mesh has no {axis!r} axis")
    group = exchange_group(group)
    device = resolve_device(device)
    dd, du, diag, hupT, hdw, nd_upT, nd_dw, amp = _dense_factors(
        op, ndw, complex_)
    dwl, upl = dd // ndw, du // ndw

    def t(a, dt=dtype):
        return torch.as_tensor(a).to(device=device, dtype=dt)

    rdt = dtype.to_real() if dtype.is_complex else dtype
    diag_l = t(diag[rank * dwl:(rank + 1) * dwl], rdt)
    hupT, hdw = t(hupT), t(hdw)
    nd_upT, nd_dw, amp = t(nd_upT, rdt), t(nd_dw, rdt), t(amp)
    nterms = len(op.nd_terms)
    nchunk = overlap if (overlap > 1 and nterms == 0
                         and upl % overlap == 0) else 1

    def matvec(x):
        """x [dw_loc, du] (this rank's rows) -> H·x, the same rows."""
        out = diag_l * x + x @ hupT
        if nchunk > 1:
            # chunked transpose: independent exchange -> product ->
            # exchange chains over column slices of every rank's up
            # block, each forward exchange started before the products so
            # the wire and the products overlap (the JAX package's
            # software double buffer)
            w = upl // nchunk
            x3 = x.reshape(dwl, ndw, upl)
            sent = []
            for c in range(nchunk):
                xc = x3[:, :, c * w:(c + 1) * w]
                send = xc.permute(1, 0, 2).contiguous()  # [ndw, dwl, w]
                sent.append(all_to_all(send, group, ndw, async_op=True))
            backs = []
            for recv, work in sent:
                work.wait()
                yt = hdw @ recv.reshape(dd, w)           # [dd, w]
                send = yt.reshape(ndw, dwl, w).contiguous()
                backs.append(all_to_all(send, group, ndw, async_op=True))
            parts = []
            for recv, work in backs:
                work.wait()
                parts.append(recv.permute(1, 0, 2))      # [dwl, ndw, w]
            return out + torch.cat(parts, dim=2).reshape(dwl, du)
        pay = [x] + [x @ nd_upT[i].to(x.dtype) for i in range(nterms)]
        pt = to_dw_major(torch.stack(pay), group, ndw)   # [1+T, dd, upl]
        yt = hdw @ pt[0]
        for i in range(nterms):
            yt = yt + amp[i] * (nd_dw[i].to(x.dtype) @ pt[1 + i])
        return out + to_up_major(yt[None], group, ndw)[0]

    return matvec, (dd, du), (rank, dwl)


def make_sharded_matvec_dense_real(op: SectorOperator, mesh,
                                   axis: str = "dw", overlap: int = 0,
                                   dtype=torch.float64, device=None):
    """Sharded dense-factor matvec of a REAL sector Hamiltonian on a real
    vector: 2 products per H·v and a [1+T]-plane payload.  ``overlap > 1``
    chunks the transpose into that many independent exchange -> product
    -> exchange chains, started asynchronously (without Jx/Jp terms, and
    when the chunks divide the up slice).  Returns (matvec, (dd_pad,
    du_pad)); ``matvec`` maps this rank's rows x [dd_pad / ndw, du_pad]
    to the same rows of H·x."""
    mv, dims, _ = _make_dense(op, mesh, axis, overlap, False, dtype, device)
    return mv, dims


def make_sharded_matvec_dense_pair(op: SectorOperator, mesh,
                                   axis: str = "dw",
                                   dtype=torch.complex128, device=None):
    """The same for a complex Hamiltonian on complex vectors (the JAX
    package's split pair as one complex tensor; the Jx/Jp amplitudes
    complex).  Returns (matvec, (dd_pad, du_pad))."""
    mv, dims, _ = _make_dense(op, mesh, axis, 0, True, dtype, device)
    return mv, dims


def _flat(mv, dims, rank_rows, op, mesh, axis, device):
    """Flat closure [dim] -> [dim]: every rank passes the whole vector,
    takes its rows, applies the sharded matvec and gathers the result."""
    group, ndw, _ = multichip.axis_info(mesh, axis)
    dd_p, du_p = dims
    rank, dwl = rank_rows
    dd, du = op.dim_dw, op.dim_up
    device = resolve_device(device)

    def apply(v):
        v = torch.as_tensor(v).to(device)
        x = torch.zeros(dd_p, du_p, dtype=v.dtype, device=device)
        x[:dd, :du] = v.reshape(dd, du)
        y = mv(x[rank * dwl:(rank + 1) * dwl])
        full = gather_rows(y[None], group, ndw)[0]
        return full[:dd, :du].reshape(-1)

    return apply


def sharded_matvec_real_flat(op: SectorOperator, mesh, axis: str = "dw",
                             overlap: int = 0, dtype=torch.float64,
                             device=None):
    """Flat real matvec [dim] -> [dim] over the sharded real dense-factor
    kernel (the whole vector in and out on every rank), or None when the
    sector Hamiltonian is not real."""
    if not op_is_real(op):
        return None
    mv, dims, rows = _make_dense(op, mesh, axis, overlap, False, dtype,
                                 device)
    return _flat(mv, dims, rows, op, mesh, axis, device)


def sharded_matvec_pair_flat(op: SectorOperator, mesh, axis: str = "dw",
                             dtype=torch.complex128, device=None):
    """Flat complex matvec [dim] -> [dim] over the sharded dense-factor
    pair kernel (the JAX package's (vr, vi) -> (wr, wi) as one complex
    vector)."""
    mv, dims, rows = _make_dense(op, mesh, axis, 0, True, dtype, device)
    return _flat(mv, dims, rows, op, mesh, axis, device)
