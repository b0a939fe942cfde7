"""Large-sector kits (Ns >= 16): block-sparse spin factors.

Port of the JAX package's ``ops/large.py``.  Beyond ``DENSE_FACTOR_MAX``
(8192) the dense spin factors of ``ops/split.py`` no longer fit and are
nearly all zeros, so each factor is stored as 128x128 dense tiles with
row- and column-block indices (block-ELL, built on the host by
:func:`block_factor_of`) and applied as a block-sparse SpMM: H_dw·X in
the natural [DimDw, DimUp] layout and H_up·Xᵀ in the transposed one.

The SpMM is the hand-written CUDA kernel ``csrc/blk_spmm.cu`` (the port
of the TPU kernel ``_pallas_blk_spmm_call``), for f32, bf16 tiles with f32
accumulation, f64, complex64, complex128 and bf16 complex tiles with
complex64 accumulation: :func:`blk_spmm` launches it
for every CUDA tensor and takes its plain version, :func:`blk_spmm_ref`,
only for tensors on the CPU.  The kernel does not walk the tiles (0.5%
full at Ns=16) but a compact form of the factor built once per
operator, a CSR of its nonzeros (:func:`blk_structure`,
:func:`blk_compact`).  The Jx/Jp terms (``nd_*``) stay plain gathers
outside the kernel, as in the JAX package.

A complex Hamiltonian takes :class:`LargePairOp`, whose tiles are complex
tensors (the JAX package's re/im/re+im planes); torch has no complex bf16
type, so its bf16 tiles (the coarse Krylov stage) are a real bf16 tensor
[T, B, B, 2] with a trailing (re, im) axis; a real one takes
:class:`LargeRealOp`, which also applies to complex vectors (both planes
run as one real product).  The padding contract (+1e6 decoupled diagonal
modes) is that of ``ops/split.py``, so ``kit.kit_for`` gives these
operators the kit interface of the dense ones.  Around the two SpMMs of
an H·v, the transposed copy of x and the sum of the diagonal term and
both products are the two kernels of ``csrc/large_glue.cu``
(:mod:`.glue`); the H·v frees each temporary as soon as it can, since at
Ns=16 one f64 vector is 1.34 GB.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import build
from ..device import resolve_device
from ..utils.timer import count, span
from . import glue
from .sector_ham import EllMatrix, SectorOperator
from .split import _PAD_DIAG, complex_dtype, real_dtype

B = 128               # tile edge
SUP = 8               # output-band height in tiles (the TPU kernel's band)

# Kernel launches in this process (one per call that reached the card),
# in all and by instantiation (the C entry point's name).
launches = 0
launches_by = {}
_entries = {}   # the C entry points, typed once at first use
_ENTRY = {torch.float32: "blk_spmm_f32", torch.bfloat16: "blk_spmm_bf16",
          torch.float64: "blk_spmm_f64", torch.complex64: "blk_spmm_c64",
          torch.complex128: "blk_spmm_c128"}
_ENTRY_BF16C = "blk_spmm_bf16c"


def is_bf16c(tiles: torch.Tensor) -> bool:
    """True for bf16 complex tiles: a real bf16 tensor [T, B, B, 2] whose
    trailing axis holds (re, im)."""
    return tiles.dtype == torch.bfloat16 and tiles.dim() == 4


def complex_tiles(tiles: torch.Tensor) -> bool:
    """True for the tiles of a complex factor (complex or bf16 complex)."""
    return tiles.is_complex() or is_bf16c(tiles)


# ---------------------------------------------------------------------------
# host-side block-ELL build
# ---------------------------------------------------------------------------

@dataclass
class BlockFactor:
    """One spin factor in block-sparse form (host arrays): a flat tile
    list in band-major, column-minor order."""
    nb: int                 # number of row/col blocks (square factor)
    row_blk: np.ndarray     # [T] i32 tile row-block index
    col_blk: np.ndarray     # [T] i32 tile col-block index
    first: np.ndarray       # [T] i32, 1 = first tile of its output band
    tiles: np.ndarray       # [T, B, B] factor dtype
    nnz: int


def block_factor_of(ell: EllMatrix, real: bool, dtype=np.float32
                    ) -> BlockFactor:
    """Block-ELL of a (possibly complex) ELL factor.  ``real=True`` keeps
    the real plane in ``dtype``; otherwise the tiles are complex128."""
    m = ell.n
    k = ell.cols.shape[1]
    rows = np.repeat(np.arange(m, dtype=np.int64), k)
    cols = ell.cols.ravel().astype(np.int64)
    vals = ell.vals.ravel()
    nz = vals != 0
    return block_factor_of_coo(m, rows[nz], cols[nz], vals[nz], real,
                               dtype)


def block_factor_of_coo(m: int, rows, cols, vals, real: bool,
                        dtype=np.float32) -> BlockFactor:
    """Block-ELL from COO triplets (large.py:89-134 of the JAX package):
    duplicates add, every output band of SUP row blocks owns at least one
    (zero) tile, and tiles run band-major, column-minor."""
    nb = -(-m // B)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    rb, cb = rows // B, cols // B
    key = rb * nb + cb
    order = np.argsort(key, kind="stable")
    rows, cols, vals, key = rows[order], cols[order], vals[order], key[order]
    uniq, start = np.unique(key, return_index=True)
    t = len(uniq)
    row_blk = (uniq // nb).astype(np.int32)
    col_blk = (uniq % nb).astype(np.int32)
    tiles = np.zeros((t, B, B), dtype if real else np.complex128)
    tid = np.searchsorted(uniq, key)
    np.add.at(tiles, (tid, rows % B, cols % B),
              vals.real if real else vals)
    # every output band owns a tile (the TPU kernel zeroed its output band
    # on the band's first tile)
    nb_sup = -(-nb // SUP)
    missing = np.setdiff1d(np.arange(nb_sup, dtype=np.int32),
                           row_blk // SUP)
    if len(missing):
        row_blk = np.concatenate([row_blk, missing * SUP])
        col_blk = np.concatenate([col_blk,
                                  np.zeros(len(missing), np.int32)])
        tiles = np.concatenate(
            [tiles, np.zeros((len(missing), B, B), tiles.dtype)])
    order = np.lexsort((row_blk, col_blk, row_blk // SUP))
    row_blk, col_blk, tiles = row_blk[order], col_blk[order], tiles[order]
    first = np.zeros(len(row_blk), np.int32)
    first[np.unique(row_blk // SUP, return_index=True)[1]] = 1
    if not real:
        tiles = tiles.astype(np.complex128)
    return BlockFactor(nb=nb, row_blk=row_blk.astype(np.int32),
                       col_blk=col_blk.astype(np.int32), first=first,
                       tiles=tiles if not real else tiles.astype(dtype),
                       nnz=int(len(rows)))


# ---------------------------------------------------------------------------
# the block-sparse SpMM: kernel wrapper and plain version
# ---------------------------------------------------------------------------

def blk_structure(rb: torch.Tensor, cb: torch.Tensor, tiles: torch.Tensor,
                  nb_out: int):
    """The nonzero structure of a tiled factor, the kernel's compact form
    without its values: (row_ptr [nb_out·B + 1] int32, cols [nnz] int32,
    pos [nnz] int64).  Row r's nonzeros are entries row_ptr[r] ..
    row_ptr[r+1] - 1, in ascending global column ``cols`` (the order in
    which the tiles of a row block sum); ``pos`` is each one's flat index
    into ``tiles``, so operators of any type with the same tile layout
    share one structure (:func:`blk_compact`).  Derived on the tiles'
    device."""
    nonzero = (tiles != 0).any(-1) if is_bf16c(tiles) else tiles != 0
    t, r, k = nonzero.nonzero(as_tuple=True)
    rows = rb.long()[t] * B + r
    cols = cb.long()[t] * B + k
    order = torch.argsort(rows * (cb.long().max() + 1) * B + cols) \
        if len(t) else t
    rows, cols = rows[order], cols[order]
    pos = ((t * B + r) * B + k)[order]
    row_ptr = torch.zeros(nb_out * B + 1, dtype=torch.long,
                          device=tiles.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=nb_out * B), 0)
    return row_ptr.int(), cols.int(), pos


def blk_compact(tiles: torch.Tensor, structure) -> tuple:
    """The kernel's compact form of ``tiles`` on ``structure`` (of
    :func:`blk_structure`): (row_ptr, cols, vals), vals [nnz] in the tile
    type ([nnz, 2] (re, im) pairs for bf16 complex tiles)."""
    row_ptr, cols, pos = structure
    if is_bf16c(tiles):
        return row_ptr, cols, tiles.reshape(-1, 2)[pos]
    return row_ptr, cols, tiles.reshape(-1)[pos]


def _chunk_cols(t: int, itemsize: int) -> int:
    """Columns per gather of the plain version: its [T, B, c] gather and
    product stay under ~1 GB each (~2 GB together)."""
    return max(1, int(1e9 // max(t * B * itemsize, 1)))


def blk_spmm_ref(rb: torch.Tensor, cb: torch.Tensor, tiles: torch.Tensor,
                 x: torch.Tensor, nb_out: int) -> torch.Tensor:
    """Plain PyTorch version (the JAX package's ``_blk_spmm_xla``):
    gather the [B, c] row block of x under each tile, one batched product
    over the tiles, and a sum of the products into their row blocks;
    chunked over the columns of x.  bf16 tiles are upcast to the type of
    x (f32 for bf16 x).  bf16 complex tiles take complex64 x, which is
    rounded to bf16 pairs as the kernel rounds it: complex products of
    bf16 inputs, accumulated in complex64."""
    if is_bf16c(tiles):
        tiles = torch.view_as_complex(tiles.float())
        x = torch.view_as_complex(
            torch.view_as_real(x.resolve_conj().to(torch.complex64))
            .to(torch.bfloat16).float())
    acc = x.dtype if x.dtype != torch.bfloat16 else torch.float32
    if tiles.dtype != acc:
        tiles = tiles.to(acc)
    x = x.to(acc)
    m_src, n = x.shape
    xb = x.reshape(m_src // B, B, n)
    rbl, cbl = rb.long(), cb.long()
    y = torch.zeros(nb_out, B, n, dtype=acc, device=x.device)
    step = _chunk_cols(tiles.shape[0], x.element_size())
    for c0 in range(0, n, step):
        g = xb[cbl, :, c0:c0 + step]                       # [T, B, c]
        y[:, :, c0:c0 + step].index_add_(0, rbl, torch.bmm(tiles, g))
    return y.reshape(nb_out * B, n)


def _kernel(entry: str):
    """The C entry point ``entry`` of the kernel, with its C types."""
    fn = _entries.get(entry)
    if fn is None:
        fn = getattr(build.load("blk_spmm"), entry)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int,
                                               ctypes.c_longlong,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[entry] = fn
    return fn


def blk_spmm(rb: torch.Tensor, cb: torch.Tensor, tiles: torch.Tensor,
             x: torch.Tensor, nb_out: int, index=None) -> torch.Tensor:
    """y [nb_out·B, n] = Σ_t tiles[t] @ x[cb[t]·B : +B, :], added into row
    block rb[t].

    tiles [T, B, B] f32, bf16, f64, complex64 or complex128, or
    [T, B, B, 2] bf16 complex; x [m_src, n] of the tile type (f32 for bf16
    tiles, cast to bf16 for the kernel, whose output is f32; complex64 for
    bf16 complex tiles, cast to bf16 pairs, complex64 output).  The kernel
    runs on ``index``, the compact form
    (row_ptr, cols, vals) of :func:`blk_compact`, derived from the tiles
    when not given (it needs no first-of-band flags: each row is written
    once, a row without nonzeros as zeros).  A CPU tensor takes
    :func:`blk_spmm_ref`; a CUDA tensor launches the kernel or raises."""
    global launches
    fn = "blk_spmm"
    cbf16 = is_bf16c(tiles)
    bf16 = tiles.dtype == torch.bfloat16 and not cbf16
    want = torch.complex64 if cbf16 else \
        torch.float32 if bf16 else tiles.dtype
    if tuple(tiles.shape[1:]) != ((B, B, 2) if cbf16 else (B, B)):
        raise ValueError(f"{fn}: tiles must be [T, {B}, {B}] (bf16 complex: "
                         f"[T, {B}, {B}, 2]), got {tuple(tiles.shape)}")
    if x.dim() != 2 or x.shape[0] % B:
        raise ValueError(f"{fn}: x must be [m, n] with m a multiple of "
                         f"{B}, got {tuple(x.shape)}")
    if x.dtype not in (want, tiles.dtype) or cbf16 and x.dtype != want:
        raise TypeError(f"{fn}: x is {x.dtype}, {want} expected for "
                        f"{tiles.dtype} tiles")
    for name, t in (("rb", rb), ("cb", cb), ("tiles", tiles)):
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} on {t.device}, x on "
                             f"{x.device}")
    if x.device.type == "cpu":
        return blk_spmm_ref(rb, cb, tiles, x, nb_out)
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if bf16:
        x = x.to(torch.bfloat16)
    elif cbf16:
        x = torch.view_as_real(x.resolve_conj()).to(torch.bfloat16)
    if not (x.is_contiguous() and tiles.is_contiguous()):
        raise ValueError(f"{fn}: x and tiles must be contiguous")
    if x.is_conj() or tiles.is_conj():
        raise ValueError(f"{fn}: lazy conjugation (call resolve_conj "
                         f"first)")
    if index is None:
        index = blk_compact(tiles, blk_structure(rb, cb, tiles, nb_out))
    row_ptr, cols, vals = index
    for name, t in (("row_ptr", row_ptr), ("cols", cols)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous int32")
    if row_ptr.numel() != nb_out * B + 1:
        raise ValueError(f"{fn}: row_ptr has {row_ptr.numel()} entries, "
                         f"{nb_out * B + 1} expected")
    per = 2 if cbf16 else 1
    if vals.dtype != tiles.dtype or vals.numel() != per * cols.numel() \
            or not vals.is_contiguous() or vals.is_conj():
        raise ValueError(f"{fn}: vals must be {per * cols.numel()} "
                         f"contiguous {tiles.dtype} values")
    for name, t in (("row_ptr", row_ptr), ("cols", cols), ("vals", vals)):
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} on {t.device}, x on "
                             f"{x.device}")
    y = torch.empty(nb_out * B, x.shape[1], device=x.device,
                    dtype=want if cbf16 or bf16 else x.dtype)
    entry = _ENTRY_BF16C if cbf16 else _ENTRY[tiles.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel(entry)(
            row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            x.data_ptr(), y.data_ptr(), nb_out * B, x.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with cudaError {err}")
    launches += 1
    launches_by[entry] = launches_by.get(entry, 0) + 1
    return y


# ---------------------------------------------------------------------------
# device operators
# ---------------------------------------------------------------------------

@dataclass
class LargeRealOp:
    """REAL sector Hamiltonian with block-sparse spin factors.  For each
    side, ``*_nz`` is the nonzero structure of :func:`blk_structure`
    (shared by the operators of every type under ``reuse``) and ``*_idx``
    the kernel's compact form of :func:`blk_compact` (values in the tile
    type)."""
    diag: torch.Tensor       # [Ddp, Dup]
    dw_rb: torch.Tensor      # [Td] i32
    dw_cb: torch.Tensor
    dw_tiles: torch.Tensor   # [Td, B, B]
    dw_nz: tuple
    dw_idx: tuple
    up_rb: torch.Tensor      # [Tu] i32 (H_up row blocks, applied to Xᵀ)
    up_cb: torch.Tensor
    up_tiles: torch.Tensor
    up_nz: tuple
    up_idx: tuple
    nd_amp: torch.Tensor     # [T]
    nd_up_src: torch.Tensor  # [T, Dup] i64 (padded: -1)
    nd_up_sgn: torch.Tensor  # [T, Dup] i8
    nd_dw_src: torch.Tensor
    nd_dw_sgn: torch.Tensor


@dataclass
class LargePairOp(LargeRealOp):
    """Complex sector Hamiltonian: the same fields with complex tiles and
    complex ``nd_amp`` (the JAX package's re/im/re+im tile planes as one
    complex tensor; bf16 tiles as [T, B, B, 2] real bf16 (re, im)
    pairs)."""


def _nd_maps(op: SectorOperator, dup: int, ddp: int):
    t = len(op.nd_terms)
    amp = np.array([x.amp for x in op.nd_terms]) if t else np.zeros(0)
    us = np.full((t, dup), -1, np.int32)
    ug = np.zeros((t, dup), np.int8)
    ds = np.full((t, ddp), -1, np.int32)
    dg = np.zeros((t, ddp), np.int8)
    for i, term in enumerate(op.nd_terms):
        us[i, :len(term.up_src)] = term.up_src
        ug[i, :len(term.up_sgn)] = term.up_sgn
        ds[i, :len(term.dw_src)] = term.dw_src
        dg[i, :len(term.dw_sgn)] = term.dw_sgn
    return amp, us, ug, ds, dg


def _padded_diag(op: SectorOperator, ddp: int, dup: int, dtype,
                 device) -> torch.Tensor:
    """The diagonal padded with +1e6 modes, computed on the device in f64
    from its factorised form (the JAX package builds it on the host;
    the same sum, in the same order)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(device)

    cross = t(op.n_dw) @ t(op.w_updw) @ t(op.n_up).T
    d = torch.full((ddp, dup), _PAD_DIAG, dtype=torch.float64,
                   device=device)
    d[:op.dim_dw, :op.dim_up] = (t(op.adw)[:, None] + t(op.aup)[None, :]
                                 + cross + op.diag_const)
    del cross
    return d.to(dtype)


def _build(cls, op: SectorOperator, real: bool, dtype, reuse, device):
    """Device operator ``cls`` of ``op``: tiles in ``dtype`` (bf16 tiles,
    real or complex, keep an f32 diagonal and f32 or complex64
    amplitudes); ``reuse`` shares the diagonal,
    the block indices, the nonzero structures and the nd arrays of a
    same-shape operator (at Ns=16 the padded f64 diagonal alone is
    1.34 GB).  ``device=None`` is the card."""
    with span("large.build", dtype=str(dtype)):
        device = resolve_device(device)
        vdt = torch.float32 if dtype == torch.bfloat16 else real_dtype(dtype)
        tdt = dtype if real else complex_dtype(vdt)
        np_dtype = np.float64 if vdt == torch.float64 else np.float32
        fu = block_factor_of(op.h_up, real=real, dtype=np_dtype)
        fd = block_factor_of(op.h_dw, real=real, dtype=np_dtype)
        dup, ddp = fu.nb * B, fd.nb * B

        def tiles(f):
            if not real and dtype == torch.bfloat16:
                # complex128 host tiles rounded once, straight to bf16 pairs
                return torch.view_as_real(torch.as_tensor(f.tiles)).to(
                    device=device, dtype=torch.bfloat16).contiguous()
            return torch.as_tensor(f.tiles).to(device=device, dtype=tdt)

        dw_tiles, up_tiles = tiles(fd), tiles(fu)
        if reuse is not None:
            kw = {k: getattr(reuse, k) for k in (
                "diag", "dw_rb", "dw_cb", "dw_nz", "up_rb", "up_cb", "up_nz",
                "nd_amp", "nd_up_src", "nd_up_sgn", "nd_dw_src", "nd_dw_sgn")}
            return cls(dw_tiles=dw_tiles, up_tiles=up_tiles,
                       dw_idx=blk_compact(dw_tiles, reuse.dw_nz),
                       up_idx=blk_compact(up_tiles, reuse.up_nz), **kw)
        amp, us, ug, ds, dg = _nd_maps(op, dup, ddp)

        def ints(a, dt=torch.int32):
            return torch.as_tensor(a).to(device=device, dtype=dt)

        dw_rb, dw_cb = ints(fd.row_blk), ints(fd.col_blk)
        up_rb, up_cb = ints(fu.row_blk), ints(fu.col_blk)
        dw_nz = blk_structure(dw_rb, dw_cb, dw_tiles, fd.nb)
        up_nz = blk_structure(up_rb, up_cb, up_tiles, fu.nb)
        return cls(
            diag=_padded_diag(op, ddp, dup, vdt, device),
            dw_rb=dw_rb, dw_cb=dw_cb, dw_tiles=dw_tiles, dw_nz=dw_nz,
            dw_idx=blk_compact(dw_tiles, dw_nz),
            up_rb=up_rb, up_cb=up_cb, up_tiles=up_tiles, up_nz=up_nz,
            up_idx=blk_compact(up_tiles, up_nz),
            nd_amp=torch.as_tensor(amp.real if real else amp.astype(
                np.complex128)).to(device=device, dtype=tdt if real else
                                   complex_dtype(vdt)),
            nd_up_src=ints(us, torch.long), nd_up_sgn=ints(ug, torch.int8),
            nd_dw_src=ints(ds, torch.long), nd_dw_sgn=ints(dg, torch.int8))


def to_device_large_real(op: SectorOperator, dtype=torch.float32,
                         reuse: LargeRealOp = None,
                         device=None) -> LargeRealOp:
    """``dtype=torch.bfloat16`` stores only the TILES in bf16 (the coarse
    Krylov stage); the diagonal and Jx/Jp amplitudes stay f32."""
    return _build(LargeRealOp, op, True, dtype, reuse, device)


def to_device_large_pair(op: SectorOperator, dtype=torch.float32,
                         reuse: LargePairOp = None,
                         device=None) -> LargePairOp:
    """Complex tiles: complex64 for ``dtype`` float32/complex64,
    complex128 for float64/complex128, bf16 (re, im) pairs [T, B, B, 2]
    for bfloat16 (the coarse Krylov stage; the diagonal stays f32 and the
    Jx/Jp amplitudes complex64, as ``to_device_large_real`` keeps them)."""
    if dtype not in (torch.float32, torch.complex64, torch.float64,
                     torch.complex128, torch.bfloat16):
        raise TypeError(f"to_device_large_pair: no {dtype} complex tiles")
    return _build(LargePairOp, op, False, dtype, reuse, device)


# ---------------------------------------------------------------------------
# matvecs
# ---------------------------------------------------------------------------

def _side(rb, cb, tiles, idx, x2: torch.Tensor, nb_out: int):
    """One factor on rows: real tiles apply to a complex x2 as one real
    product over its (re, im) columns."""
    if x2.is_complex() and not complex_tiles(tiles):
        n = x2.shape[1]
        xr = torch.view_as_real(x2.resolve_conj()).reshape(x2.shape[0],
                                                           2 * n)
        y = blk_spmm(rb, cb, tiles, xr, nb_out, index=idx)
        return torch.view_as_complex(y.reshape(-1, n, 2))
    return blk_spmm(rb, cb, tiles, x2.resolve_conj().contiguous(),
                    nb_out, index=idx)


def _dw(op: LargeRealOp, x2: torch.Tensor) -> torch.Tensor:
    return _side(op.dw_rb, op.dw_cb, op.dw_tiles, op.dw_idx, x2,
                 op.diag.shape[0] // B)


def _up(op: LargeRealOp, x2: torch.Tensor) -> torch.Tensor:
    return _side(op.up_rb, op.up_cb, op.up_tiles, op.up_idx, x2,
                 op.diag.shape[1] // B)


def _nd_apply(x: torch.Tensor, xt: torch.Tensor, op: LargeRealOp
              ) -> torch.Tensor:
    """Jx/Jp Kronecker terms via row gathers in both layouts: the up
    factor is applied on xt (row gather over up), transposed back, then
    the dw factor as a row gather over dw."""
    out = torch.zeros_like(x)
    for ti in range(op.nd_amp.shape[0]):
        tu = xt[op.nd_up_src[ti].clamp_min(0)] \
            * op.nd_up_sgn[ti][:, None].to(x.dtype)
        y = tu.T[op.nd_dw_src[ti].clamp_min(0)] \
            * op.nd_dw_sgn[ti][:, None].to(x.dtype)
        out = out + op.nd_amp[ti].to(x.dtype) * y
    return out


def _apply(op: LargeRealOp, x3: torch.Tensor) -> torch.Tensor:
    """H·x for a batch x3 [bb, ddp, dup], the batch folded into the SpMM
    width: the glue of :mod:`.glue` around two block-sparse SpMMs (dw in
    the natural layout, up in the transposed one), then the Jx/Jp terms.
    At most three vectors besides x are alive at once (four with Jx/Jp
    terms, whose gathers read xt)."""
    x3 = x3.resolve_conj().contiguous()
    bb, ddp, dup = x3.shape
    xt, xdw = glue.pack(x3)
    y_up = _up(op, xt)
    nd = op.nd_amp.shape[0] > 0
    if not nd:
        del xt
    y_dw = _dw(op, xdw)
    del xdw
    out = glue.combine(op.diag, x3, y_dw, y_up)
    del y_dw, y_up
    if out.is_cuda:
        count("large.fused_glue")
    if nd:
        xt3 = xt.view(dup, ddp, bb)
        for i in range(bb):
            out[i] += _nd_apply(x3[i], xt3[:, :, i], op)
    return out


def matvec_large_real(op: LargeRealOp, x: torch.Tensor) -> torch.Tensor:
    """H·x for x [Ddp, Dup].  ``op`` may be a :class:`LargePairOp`
    (complex tiles) and x real or complex; real tiles apply to both
    planes of a complex x."""
    return _apply(op, x[None])[0]


def apply_large_real_flat(dev: LargeRealOp, x: torch.Tensor
                          ) -> torch.Tensor:
    """Flat matvec of any tile kit (real or complex tiles, real or
    complex x): x [dim_p] -> H·x, or rows [m, dim_p] applied one by one
    (the refine's blocks; the GF chains fold their rows with
    :func:`apply_large_real_flat_batched`)."""
    sh = tuple(dev.diag.shape)
    if x.dim() == 1:
        return matvec_large_real(dev, x.reshape(sh)).reshape(-1)
    return torch.stack([matvec_large_real(dev, r.reshape(sh)).reshape(-1)
                        for r in x])


def apply_large_real_flat_batched(dev: LargeRealOp, x: torch.Tensor
                                  ) -> torch.Tensor:
    """x [Bb, dim_p] -> [Bb, dim_p], the batch folded into the SpMM width
    (one wide SpMM per side instead of Bb narrow ones)."""
    return _apply(dev, x.reshape((x.shape[0],) + tuple(dev.diag.shape))
                  ).reshape(x.shape[0], -1)

