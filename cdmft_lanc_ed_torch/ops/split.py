"""Dense-factor sector kits: the real kit and the complex pair kit (the
JAX package's ``ops/split.py``, :161-304 and :326-595).

A sector Hamiltonian acts on the sector vector viewed as X [DimDw, DimUp]
as

    H·x = diag ⊙ X + H_dw · X + X · H_upᵀ  (+ Σ_t amp_t O^dw_t X O^upᵀ_t)

with the two spin factors stored as small dense matrices: the full H is
never materialised.  A real Hamiltonian takes the real kit
(:class:`DenseRealOp`, one real plane); a complex one takes the pair kit
(:class:`DenseComplexOp`, complex tensors: the card has complex64 and
complex128, so the JAX package's re/im planes become one tensor); complex
vectors on a real operator take its two real planes
(:func:`apply_realpair_flat`).  An f32
plane or a complex64 vector goes to the hand-written CUDA kernels
(:mod:`.fused`); f64 and complex128 (Rayleigh-Ritz refine, GF
tridiagonalisation, ``ed_precision="complex128"``) are left to
``torch.matmul``, as the JAX package leaves them to XLA.  The Jx/Jp terms
(``nd_*``, empty for Hubbard and BHZ) stay ``torch.matmul`` outside the
kernels.

Sector dims snap to the ``_BUCKETS`` ladder: padded modes carry a +1e6
diagonal and are decoupled, so vectors that start zero there stay zero.
The ladder decides which sectors are solved together in one batch.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from . import fused
from .sector_ham import SectorOperator

# geometric shape ladder of the JAX package (split.py:197-207)
_BUCKETS = (128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096,
            6144, 8192)

# dense-factor size limit: larger spin factors need the block-sparse kit
DENSE_FACTOR_MAX = 8192

_PAD_DIAG = 1e6   # decoupled padding modes sit far above the spectrum


def _bucket(n: int) -> int:
    if n <= 64:
        return n            # tiny dims: padding overhead dominates
    for b in _BUCKETS:
        if n <= b:
            return b
    return -(-n // 1024) * 1024


@dataclass
class DenseRealOp:
    """Sector Hamiltonian with REAL dense spin factors.  Every field may
    carry a leading batch axis (same-bucket sectors stacked)."""
    diag: torch.Tensor        # [DimDw, DimUp]
    hdw: torch.Tensor         # [DimDw, DimDw]
    hupT: torch.Tensor        # [DimUp, DimUp] (pre-transposed)
    nd_amp: torch.Tensor      # [T]
    nd_upT: torch.Tensor      # [T, DimUp, DimUp]
    nd_dw: torch.Tensor       # [T, DimDw, DimDw]


def op_is_real(op: SectorOperator) -> bool:
    """True when every term of the sector Hamiltonian is real (the diagonal
    always is): real spin factors and real Jx/Jp amplitudes."""
    if op.h_up.vals.size and np.abs(op.h_up.vals.imag).max() != 0.0:
        return False
    if op.h_dw.vals.size and np.abs(op.h_dw.vals.imag).max() != 0.0:
        return False
    return all(complex(t.amp).imag == 0.0 for t in op.nd_terms)


def _dense_real_host(op: SectorOperator, pad_to: Optional[tuple]) -> dict:
    """Host float64 arrays of :class:`DenseRealOp` (padding contract of
    the JAX package's to_device_dense_split)."""
    hu = op.h_up.to_dense().real
    hd = op.h_dw.to_dense().real
    du, dd = op.dim_up, op.dim_dw
    diag = op.diag()
    if pad_to is not None:
        ddp, dup = pad_to
        diag_p = np.full((ddp, dup), _PAD_DIAG)
        diag_p[:dd, :du] = diag
        diag = diag_p
        hu_p = np.zeros((dup, dup))
        hu_p[:du, :du] = hu
        hu = hu_p
        hd_p = np.zeros((ddp, ddp))
        hd_p[:dd, :dd] = hd
        hd = hd_p
        du, dd = dup, ddp
    t = len(op.nd_terms)
    nd_amp = np.zeros(t)
    nd_upT = np.zeros((t, du, du))
    nd_dw = np.zeros((t, dd, dd))
    for i, term in enumerate(op.nd_terms):
        nd_amp[i] = complex(term.amp).real
        iu = np.nonzero(term.up_src >= 0)[0]
        nd_upT[i, term.up_src[iu], iu] = term.up_sgn[iu]
        idw = np.nonzero(term.dw_src >= 0)[0]
        nd_dw[i, idw, term.dw_src[idw]] = term.dw_sgn[idw]
    return dict(diag=diag, hdw=hd, hupT=hu.T, nd_amp=nd_amp, nd_upT=nd_upT,
                nd_dw=nd_dw)


def _to_op(host: dict, dtype, device, cls=None):
    """``cls`` (default :class:`DenseRealOp`) of the host arrays in
    ``host``; ``dtype`` is the real dtype, and complex fields take its
    complex counterpart.  ``device=None`` is the card."""
    ctype = complex_dtype(dtype)
    device = resolve_device(device)
    return (cls or DenseRealOp)(**{
        k: torch.as_tensor(np.ascontiguousarray(v)).to(
            device=device, dtype=ctype if np.iscomplexobj(v) else dtype)
        for k, v in host.items()})


def to_device_dense_real(op: SectorOperator, pad_to: tuple = None,
                         dtype=torch.float64, device=None) -> DenseRealOp:
    """Device arrays of the real dense-factor kit, optionally zero-padded
    to the bucket shape ``pad_to=(ddp, dup)``."""
    return _to_op(_dense_real_host(op, pad_to), dtype, device)


def stack_real_ops(ops, pad: tuple, dtype=torch.float64,
                   device=None) -> DenseRealOp:
    """Stacked DenseRealOp with a leading batch axis over same-bucket
    sectors (for :func:`apply_real_flat`, which broadcasts over it)."""
    ddp, dup = pad
    hosts = [_dense_real_host(
        op, None if (op.dim_dw, op.dim_up) == (ddp, dup) else pad)
        for op in ops]
    return _to_op({f.name: np.stack([h[f.name] for h in hosts])
                   for f in fields(DenseRealOp)}, dtype, device)


def matvec_dense_real(op: DenseRealOp, x: torch.Tensor) -> torch.Tensor:
    """H·x for a REAL plane x [..., DimDw, DimUp].  The operator is either
    unbatched (shared by every leading index of x) or batched with the
    same single leading axis as x.  f32 goes to the fused CUDA kernel
    (its plain version on the CPU); f64 runs the two matmuls."""
    if x.dtype == torch.float32:
        lead = x.shape[:-2]
        x3 = x.reshape((-1,) + tuple(x.shape[-2:])) if len(lead) != 1 \
            else x
        out = fused.fused_real_matvec(op.diag, op.hdw, op.hupT,
                                      x3.contiguous()).reshape(x.shape)
    else:
        out = op.diag * x + op.hdw @ x + x @ op.hupT
    for t in range(op.nd_amp.shape[-1]):
        out = out + op.nd_amp[..., t, None, None] * (
            op.nd_dw[..., t, :, :] @ (x @ op.nd_upT[..., t, :, :]))
    return out


def apply_real_flat(dev: DenseRealOp, x: torch.Tensor) -> torch.Tensor:
    """Flat one-plane matvec: x [..., dim_p] -> H·x [..., dim_p].  A
    stacked ``dev`` and x [B, dim_p] share the leading batch axis, which
    the broadcasting products handle."""
    sh = tuple(dev.diag.shape[-2:])
    return matvec_dense_real(dev, x.reshape(x.shape[:-1] + sh)) \
        .reshape(x.shape)



# ---------------------------------------------------------------------------
# complex pair kit
# ---------------------------------------------------------------------------

_COMPLEX = {torch.float64: torch.complex128, torch.float32: torch.complex64,
            torch.complex128: torch.complex128,
            torch.complex64: torch.complex64}


def complex_dtype(dtype) -> torch.dtype:
    """complex128 for float64 (or complex128), complex64 for float32 (or
    complex64): the pair kit's vectors at a plane precision."""
    return _COMPLEX[dtype]


def real_dtype(dtype) -> torch.dtype:
    """float64 for float64/complex128, float32 for float32/complex64."""
    return torch.float32 if dtype in (torch.float32, torch.complex64) \
        else torch.float64


@dataclass
class DenseComplexOp:
    """Sector Hamiltonian with COMPLEX dense spin factors: the JAX
    package's ``DenseSplitOp`` (split.py:161-189) with each re/im/re+im
    plane triple held as one complex tensor.  Every field may carry a
    leading batch axis (same-bucket sectors stacked)."""
    diag: torch.Tensor        # [DimDw, DimUp] real
    hdw: torch.Tensor         # [DimDw, DimDw] complex
    hupT: torch.Tensor        # [DimUp, DimUp] complex: H_upᵀ, not H_upᴴ
    nd_amp: torch.Tensor      # [T] complex
    nd_upT: torch.Tensor      # [T, DimUp, DimUp] real sign patterns
    nd_dw: torch.Tensor       # [T, DimDw, DimDw] real


def _dense_pair_host(op: SectorOperator, pad_to: Optional[tuple]) -> dict:
    """Host arrays of :class:`DenseComplexOp` (complex128 factors; the
    padding contract of the JAX package's to_device_dense_split)."""
    host = _dense_real_host(op, pad_to)
    hu = op.h_up.to_dense()
    hd = op.h_dw.to_dense()
    du, dd = host["diag"].shape[1], host["diag"].shape[0]
    hu_p = np.zeros((du, du), np.complex128)
    hu_p[:op.dim_up, :op.dim_up] = hu
    hd_p = np.zeros((dd, dd), np.complex128)
    hd_p[:op.dim_dw, :op.dim_dw] = hd
    host.update(hdw=hd_p, hupT=hu_p.T,
                nd_amp=np.array([complex(t.amp) for t in op.nd_terms],
                                np.complex128))
    return host


def to_device_dense_split(op: SectorOperator, pad_to: tuple = None,
                          dtype=torch.float64, device=None
                          ) -> DenseComplexOp:
    """Device tensors of the pair kit, optionally zero-padded to the
    bucket shape ``pad_to=(ddp, dup)``.  ``dtype`` float64 gives a
    complex128 operator, float32 a complex64 one (the kernel's)."""
    return _to_op(_dense_pair_host(op, pad_to), real_dtype(dtype), device,
                  DenseComplexOp)


def stack_pair_ops(ops, pad: tuple, dtype=torch.float64,
                   device=None) -> DenseComplexOp:
    """Stacked DenseComplexOp with a leading batch axis over same-bucket
    sectors (for :func:`apply_pair_flat`, which broadcasts over it)."""
    ddp, dup = pad
    hosts = [_dense_pair_host(
        op, None if (op.dim_dw, op.dim_up) == (ddp, dup) else pad)
        for op in ops]
    return _to_op({f.name: np.stack([h[f.name] for h in hosts])
                   for f in fields(DenseComplexOp)}, real_dtype(dtype),
                  device, DenseComplexOp)


def matvec_dense_pair(op: DenseComplexOp, x: torch.Tensor) -> torch.Tensor:
    """H·x for a complex x [..., DimDw, DimUp] (the JAX package's
    split.matvec_dense_pair on one complex tensor instead of an (xr, xi)
    pair).  Operator batching as :func:`matvec_dense_real`.  complex64
    goes to the fused CUDA kernel (its plain version on the CPU);
    complex128 runs the two matmuls."""
    if x.dtype == torch.complex64:
        lead = x.shape[:-2]
        x3 = x.reshape((-1,) + tuple(x.shape[-2:])) if len(lead) != 1 \
            else x
        out = fused.fused_pair_matvec(op.diag, op.hdw, op.hupT,
                                      x3.resolve_conj().contiguous()
                                      ).reshape(x.shape)
    else:
        out = op.diag * x + op.hdw @ x + x @ op.hupT
    for t in range(op.nd_amp.shape[-1]):
        up = op.nd_upT[..., t, :, :].to(x.dtype)
        dw = op.nd_dw[..., t, :, :].to(x.dtype)
        out = out + op.nd_amp[..., t, None, None] * (dw @ (x @ up))
    return out


def apply_pair_flat(dev: DenseComplexOp, x: torch.Tensor) -> torch.Tensor:
    """Flat complex matvec: x [..., dim_p] -> H·x [..., dim_p] (a stacked
    ``dev`` as in :func:`apply_real_flat`)."""
    sh = tuple(dev.diag.shape[-2:])
    return matvec_dense_pair(dev, x.reshape(x.shape[:-1] + sh)) \
        .reshape(x.shape)



# Applications of a real operator to complex vectors in this process (one
# per apply_realpair_flat call, on any device).
realpair_applications = 0


def apply_realpair_flat(dev: DenseRealOp, x: torch.Tensor) -> torch.Tensor:
    """Real operator on complex vectors: x [..., dim_p] complex -> H·x.
    The (re, im) planes never mix, so H·x is two real products per side
    instead of the pair kit's complex ones (the JAX package's
    split.py:418-421 and :478-482).  An unbatched operator takes both
    planes of every vector in one product, [2, ...] stacked (f32: one
    fused-kernel launch); a batched one ([B, ...] fields, x [B, dim_p])
    takes each plane in its own."""
    global realpair_applications
    realpair_applications += 1
    sh = x.shape[:-1] + tuple(dev.diag.shape[-2:])
    if dev.diag.dim() == 2:
        planes = torch.stack((x.real, x.imag)).reshape((2,) + sh)
        out = matvec_dense_real(dev, planes)
        re, im = out[0], out[1]
    else:
        re = matvec_dense_real(dev, x.real.reshape(sh).contiguous())
        im = matvec_dense_real(dev, x.imag.reshape(sh).contiguous())
    return torch.complex(re, im).reshape(x.shape)


def embed_real(v, dd: int, du: int, ddp: int, dup: int):
    """Flat vectors [*, dd*du] -> padded [*, ddp*dup] (zeros in the
    decoupled padding modes); a complex array stays complex, a host
    array on the host and a tensor on its device."""
    if isinstance(v, torch.Tensor):
        lead = tuple(v.shape[:-1])
        return torch.nn.functional.pad(
            v.reshape(lead + (dd, du)), (0, dup - du, 0, ddp - dd)) \
            .reshape(lead + (ddp * dup,))
    v = np.asarray(v)
    out = np.zeros(v.shape[:-1] + (ddp, dup), v.dtype)
    out[..., :dd, :du] = v.reshape(v.shape[:-1] + (dd, du))
    return out.reshape(v.shape[:-1] + (ddp * dup,))


def extract_real(v, dd: int, du: int, ddp: int, dup: int):
    """Inverse of :func:`embed_real`."""
    if not isinstance(v, torch.Tensor):
        v = np.asarray(v)
    lead = tuple(v.shape[:-1])
    return v.reshape(lead + (ddp, dup))[..., :dd, :du] \
        .reshape(lead + (dd * du,))
