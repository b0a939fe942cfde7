"""Sharded large-sector H·v: block-sparse factors and the all-to-all
transpose.

Port of the JAX package's ``parallel/sharded_large.py``: the mesh path for
sectors whose spin factors are block-sparse (Ns >= 16), and, on a mesh,
for every sector of dim >= 64·lanc_dim_threshold.  Each rank of the
mesh's "dw" axis holds this rank's rows of the padded sector vector,
x_loc [dw_loc, DimUp_p], and the whole (replicated) tile sets:

* up side: local, in the transposed layout: one ``large.blk_spmm``;
* dw side: one all-to-all to [DimDw_p, up_loc], one ``large.blk_spmm``,
  one all-to-all back (``sharded_spmv.to_dw_major`` / ``to_up_major``);
* the Jx/Jp terms fold into the same two exchanges.

The products are the port's ``large.blk_spmm``, so the CUDA kernel
``csrc/blk_spmm.cu`` runs on every rank (its plain version on the CPU).
Both dims are padded with +1e6 diagonal modes (``ops/large.py``'s
contract) to multiples of the 128 tile and of the "dw" size.  The
operator carries the "dw" process group (``group``), which
``ops/lanczos.py`` reads to sum every inner product over the ranks.  Flat
vectors of the appliers are this rank's rows, [dw_loc·DimUp_p], of real
or complex vectors on real or complex tiles; :func:`shard_rows` and
:func:`gather_vector` map whole vectors to them and back.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import large
from ..ops.large import B
from ..ops.sector_ham import SectorOperator
from ..ops.split import complex_dtype, op_is_real, real_dtype
from . import multichip
from .sharded_spmv import (exchange_group, gather_rows, to_dw_major,
                           to_up_major)


@dataclass
class ShardedLargeRealOp:
    """REAL sector Hamiltonian sharded along dw: this rank's rows of the
    padded diagonal and the replicated factors in the fields of
    ``large.LargeRealOp``, with the "dw" group and the shapes."""
    diag: torch.Tensor       # [dw_loc, dup] this rank's rows
    dw_rb: torch.Tensor
    dw_cb: torch.Tensor
    dw_tiles: torch.Tensor
    dw_nz: tuple
    dw_idx: tuple
    up_rb: torch.Tensor
    up_cb: torch.Tensor
    up_tiles: torch.Tensor
    up_nz: tuple
    up_idx: tuple
    nd_amp: torch.Tensor
    nd_up_src: torch.Tensor  # [T, dup] i64 (padded: -1)
    nd_up_sgn: torch.Tensor
    nd_dw_src: torch.Tensor  # [T, ddp]
    nd_dw_sgn: torch.Tensor
    group: object            # the "dw" process group (None: one gloo rank)
    ndw: int                 # ranks on the dw axis
    rank: int                # this rank's index on it
    dd: int                  # unpadded dims
    du: int
    ddp: int                 # padded dims
    dup: int


@dataclass
class ShardedLargePairOp(ShardedLargeRealOp):
    """Complex sector Hamiltonian: complex tiles and amplitudes (the JAX
    package's Karatsuba planes as one complex tensor)."""


def _blocks(nb: int, ndw: int) -> int:
    """Row blocks raised until ``ndw`` divides nb·B."""
    step = ndw // math.gcd(ndw, B)
    return -(-nb // step) * step


def _build(cls, op: SectorOperator, mesh, axis: str, real: bool, dtype,
           reuse, device):
    group, ndw, rank = multichip.axis_info(mesh, axis)
    if group is None:
        raise ValueError(f"the mesh has no {axis!r} axis")
    device = resolve_device(device)
    vdt = real_dtype(dtype)
    tdt = dtype if real else complex_dtype(vdt)
    np_dtype = np.float64 if vdt == torch.float64 else np.float32
    fu = large.block_factor_of(op.h_up, real=real, dtype=np_dtype)
    fd = large.block_factor_of(op.h_dw, real=real, dtype=np_dtype)
    nbu, nbd = _blocks(fu.nb, ndw), _blocks(fd.nb, ndw)
    dup, ddp = nbu * B, nbd * B
    dwl = ddp // ndw

    def tiles(f):
        return torch.as_tensor(f.tiles).to(device=device, dtype=tdt)

    def ints(a, dt=torch.int32):
        return torch.as_tensor(a).to(device=device, dtype=dt)

    dw_tiles, up_tiles = tiles(fd), tiles(fu)
    if reuse is not None:
        kw = {k: getattr(reuse, k) for k in (
            "dw_rb", "dw_cb", "dw_nz", "up_rb", "up_cb", "up_nz",
            "nd_up_src", "nd_up_sgn", "nd_dw_src", "nd_dw_sgn")}
    else:
        dw_rb, dw_cb = ints(fd.row_blk), ints(fd.col_blk)
        up_rb, up_cb = ints(fu.row_blk), ints(fu.col_blk)
        _, us, ug, ds, dg = large._nd_maps(op, dup, ddp)
        kw = dict(dw_rb=dw_rb, dw_cb=dw_cb,
                  dw_nz=large.blk_structure(dw_rb, dw_cb, dw_tiles, nbd),
                  up_rb=up_rb, up_cb=up_cb,
                  up_nz=large.blk_structure(up_rb, up_cb, up_tiles, nbu),
                  nd_up_src=ints(us, torch.long),
                  nd_up_sgn=ints(ug, torch.int8),
                  nd_dw_src=ints(ds, torch.long),
                  nd_dw_sgn=ints(dg, torch.int8))
    amp = np.array([x.amp for x in op.nd_terms]) if op.nd_terms \
        else np.zeros(0)
    diag = large._padded_diag(op, ddp, dup, vdt, device)
    if ndw > 1:
        diag = diag[rank * dwl:(rank + 1) * dwl].clone()
    return cls(
        diag=diag, dw_tiles=dw_tiles,
        dw_idx=large.blk_compact(dw_tiles, kw["dw_nz"]),
        up_tiles=up_tiles, up_idx=large.blk_compact(up_tiles, kw["up_nz"]),
        nd_amp=torch.as_tensor(amp.real if real else amp.astype(
            np.complex128)).to(device=device, dtype=tdt),
        group=exchange_group(group), ndw=ndw, rank=rank, dd=op.dim_dw,
        du=op.dim_up, ddp=ddp, dup=dup, **kw)


def build_sharded_large_real(op: SectorOperator, mesh, axis: str = "dw",
                             dtype=torch.float32, reuse=None, device=None):
    """:class:`ShardedLargeRealOp` of ``op`` with tiles in ``dtype`` (f32
    or f64), or None when the sector Hamiltonian is not real.  ``reuse``
    shares the block indices, nonzero structures and Jx/Jp maps of a
    same-sector operator (the f64 build after an f32 one)."""
    if not op_is_real(op):
        return None
    return _build(ShardedLargeRealOp, op, mesh, axis, True, dtype, reuse,
                  device)


def build_sharded_large_pair(op: SectorOperator, mesh, axis: str = "dw",
                             dtype=torch.float32, reuse=None, device=None):
    """:class:`ShardedLargePairOp` of ``op``: complex64 tiles for
    ``dtype`` float32/complex64, complex128 for float64/complex128."""
    return _build(ShardedLargePairOp, op, mesh, axis, False, dtype, reuse,
                  device)


def _apply(op: ShardedLargeRealOp, x3: torch.Tensor) -> torch.Tensor:
    """H·x for this rank's rows x3 [Bb, dw_loc, dup] of Bb vectors, the
    batch folded into the SpMM width on both sides."""
    bb, dwl, dup = x3.shape
    ddp, ndw = op.ddp, op.ndw
    upl = dup // ndw
    out = op.diag[None] * x3
    # up side, local in the transposed layout: minor axis (dw_loc, batch)
    xt = x3.permute(2, 1, 0).reshape(dup, dwl * bb)
    y = large._side(op.up_rb, op.up_cb, op.up_tiles, op.up_idx, xt,
                    dup // B)
    out += y.reshape(dup, dwl, bb).permute(2, 1, 0)
    del y
    # Jx/Jp up factors before the transpose (the batch rides the payload)
    pay = [x3]
    xt3 = xt.reshape(dup, dwl, bb)
    for ti in range(op.nd_amp.shape[0]):
        tu = xt3[op.nd_up_src[ti].clamp_min(0)] \
            * op.nd_up_sgn[ti][:, None, None].to(x3.dtype)
        pay.append(tu.permute(2, 1, 0))
    del xt, xt3
    pt = to_dw_major(torch.stack(pay) if len(pay) > 1 else x3[None],
                     op.group, ndw)                     # [1+T, Bb, ddp, upl]
    del pay
    # dw side: minor axis (up_loc, batch)
    vf = pt[0].permute(1, 2, 0).reshape(ddp, upl * bb)
    y = large._side(op.dw_rb, op.dw_cb, op.dw_tiles, op.dw_idx, vf,
                    ddp // B)
    del vf
    y = y.reshape(ddp, upl, bb).permute(2, 0, 1)
    for ti in range(op.nd_amp.shape[0]):
        y = y + op.nd_amp[ti].to(x3.dtype) * (
            pt[1 + ti][:, op.nd_dw_src[ti].clamp_min(0), :]
            * op.nd_dw_sgn[ti][None, :, None].to(x3.dtype))
    del pt
    out += to_up_major(y, op.group, ndw)
    return out


def apply_sharded_large_real_flat(op: ShardedLargeRealOp, x: torch.Tensor
                                  ) -> torch.Tensor:
    """Flat matvec of this rank's rows: x [dw_loc·dup] -> H·x, or rows
    [m, dw_loc·dup] applied one by one (the refine's blocks)."""
    sh = (1, op.ddp // op.ndw, op.dup)
    if x.dim() == 1:
        return _apply(op, x.reshape(sh)).reshape(-1)
    return torch.stack([_apply(op, r.reshape(sh)).reshape(-1) for r in x])


def apply_sharded_large_real_flat_batched(op: ShardedLargeRealOp,
                                          x: torch.Tensor) -> torch.Tensor:
    """x [Bb, dw_loc·dup] -> [Bb, dw_loc·dup], the batch folded into the
    SpMM width (one wide SpMM per side instead of Bb narrow ones)."""
    bb = x.shape[0]
    return _apply(op, x.reshape(bb, op.ddp // op.ndw, op.dup)) \
        .reshape(bb, -1)


def shard_rows(op: ShardedLargeRealOp, v):
    """Whole unpadded vectors [*, dd·du] (host array or tensor) -> this
    rank's padded rows [*, dw_loc·dup] (host stays host)."""
    dwl = op.ddp // op.ndw
    lo = op.rank * dwl
    hi = max(lo, min(op.dd, lo + dwl))
    lead = tuple(v.shape[:-1])
    if isinstance(v, torch.Tensor):
        out = torch.zeros(lead + (dwl, op.dup), dtype=v.dtype,
                          device=v.device)
    else:
        out = np.zeros(lead + (dwl, op.dup), np.asarray(v).dtype)
    out[..., :hi - lo, :op.du] = v.reshape(lead + (op.dd, op.du))[
        ..., lo:hi, :]
    return out.reshape(lead + (dwl * op.dup,))


def gather_vector(op: ShardedLargeRealOp, v: torch.Tensor) -> torch.Tensor:
    """This rank's rows [*, dw_loc·dup] of every rank -> the whole
    unpadded vectors [*, dd·du] on every rank (one all-gather)."""
    lead = tuple(v.shape[:-1])
    full = gather_rows(v.reshape(-1, op.ddp // op.ndw, op.dup), op.group,
                       op.ndw)
    return full[:, :op.dd, :op.du].reshape(lead + (op.dd * op.du,))


def _flat(build, op, mesh, axis, dtype, device):
    dev = build(op, mesh, axis, dtype=dtype, device=device)
    if dev is None:
        return None

    def apply(v):
        x = shard_rows(dev, torch.as_tensor(v).to(dev.diag.device,
                                                  dev.dw_tiles.dtype))
        return gather_vector(dev, apply_sharded_large_real_flat(dev, x))

    return apply


def sharded_matvec_large_real_flat(op: SectorOperator, mesh,
                                   axis: str = "dw", dtype=torch.float32,
                                   device=None):
    """Flat [dim] -> [dim] closure over the sharded block-sparse matvec
    (the whole vector in and out on every rank), or None when the sector
    Hamiltonian is not real."""
    return _flat(build_sharded_large_real, op, mesh, axis, dtype, device)


def sharded_matvec_large_pair_flat(op: SectorOperator, mesh,
                                   axis: str = "dw", dtype=torch.float32,
                                   device=None):
    """The same over the complex tiles (the JAX package's (vr, vi) pair
    as one complex vector)."""
    return _flat(build_sharded_large_pair, op, mesh, axis, dtype, device)
