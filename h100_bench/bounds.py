"""The roofline arithmetic of the benchmark, frozen here: H100 data-sheet
peaks and each kernel's least time (operations over the peak, or bytes
moved once over the HBM bandwidth, whichever is larger).

Copied from the repository's ``chip_smoke.py``: the peaks from
``PEAKS``, ``PEAK_BF16`` and ``PEAK_F64``; the fused H·v's cost from
``fused_cost`` / ``fused_bound_ms`` (real and complex branches); the
block-sparse SpMM's
from ``blk_bound``, ``blk_io_bytes``, ``blk_cost`` (dense tiles) and
``blk_compact_cost`` (the compact nonzeros the kernel reads).  Times here
are in seconds.
"""
from __future__ import annotations

from typing import Tuple

# NVIDIA H100 data sheet, dense rates without sparsity, at 700 W: FP32
# outside the tensor cores and HBM bandwidth, for the SXM part and the PCIe
# part; bf16 on the tensor cores; FP64 outside them.  Complex types take
# their real type's peak.
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12)}
PEAK_BF16 = 989e12
PEAK_F64 = 34e12


def peaks_of(device_name: str) -> Tuple[float, float]:
    """(FP32 FLOP/s, HBM bytes/s) of the card named ``device_name``."""
    return PEAKS["pcie" if "pcie" in device_name.lower() else "sxm"]


def _bound(ops: float, nbytes: float, peak_ops: float,
           bandwidth: float) -> Tuple[float, str]:
    t_ops, t_bytes = ops / peak_ops, nbytes / bandwidth
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def fused_real_cost(b: int, d: int, u: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of ``b`` fused real H·v out = diag⊙X + H_dw X +
    X H_upᵀ on X [d, u] in f32: 2·d·u·(d+u) + 2·d·u operations; diag, X,
    H_dw, H_upᵀ read once and the output written once."""
    return (b * (2.0 * d * u * (d + u) + 2.0 * d * u),
            b * 4.0 * (3 * d * u + d * d + u * u))


def fused_real_bound_s(b: int, d: int, u: int,
                       peaks=PEAKS["sxm"]) -> Tuple[float, str]:
    """(least seconds, what bounds it) of one launch at (B, D, U)."""
    flops, nbytes = fused_real_cost(b, d, u)
    return _bound(flops, nbytes, peaks[0], peaks[1])


def fused_pair_cost(b: int, d: int, u: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of ``b`` fused complex H·v in complex64 with a real
    f32 diag: 6·d·u·(d+u) + 4·d·u operations, the Karatsuba form's own
    count; each input read once and the output written once."""
    return (b * (6.0 * d * u * (d + u) + 4.0 * d * u),
            b * (4.0 * d * u + 8.0 * (2 * d * u + d * d + u * u)))


def fused_pair_bound_s(b: int, d: int, u: int,
                       peaks=PEAKS["sxm"]) -> Tuple[float, str]:
    """(least seconds, what bounds it) of one complex launch at (B, D, U)."""
    flops, nbytes = fused_pair_cost(b, d, u)
    return _bound(flops, nbytes, peaks[0], peaks[1])


# block-sparse SpMM instantiations: (peak of the type, bytes of one x
# element as the kernel reads it, bytes of one y element, real operations
# per stored nonzero and column)
BLK_KINDS = {
    "f32": (None, 4, 4, 2.0), "bf16": (PEAK_BF16, 2, 4, 2.0),
    "f64": (PEAK_F64, 8, 8, 2.0), "c64": (None, 8, 8, 8.0),
    "c128": (PEAK_F64, 16, 16, 8.0), "bf16c": (PEAK_BF16, 4, 8, 8.0)}


def blk_bound_s(kind: str, nnz: int, rows: int, n: int, x_rows: int,
                vals_bytes: int, peaks=PEAKS["sxm"]) -> Tuple[float, str]:
    """(least seconds, what bounds it) of one block-sparse SpMM of
    instantiation ``kind`` reading its factor in the compact form: row
    offsets (``rows`` + 1) and ``nnz`` columns as int32, ``vals_bytes`` of
    values, x [x_rows, n] read once and y [rows, n] written once;
    ``nnz``·n multiply-adds."""
    peak, x_item, y_item, per = BLK_KINDS[kind]
    nbytes = 4 * (rows + 1 + nnz) + vals_bytes \
        + x_item * x_rows * n + y_item * rows * n
    return _bound(per * nnz * n, nbytes, peak or peaks[0], peaks[1])


def blk_dense_bound_s(kind: str, tiles: int, nnz: int, rows: int, n: int,
                      x_rows: int, tile_item: int,
                      peaks=PEAKS["sxm"]) -> Tuple[float, str]:
    """The same SpMM with the factor read as ``tiles`` dense 128x128 tiles
    of ``tile_item`` bytes per entry (the bound of the kernel table's
    dense column)."""
    peak, x_item, y_item, per = BLK_KINDS[kind]
    nbytes = tile_item * tiles * 128 * 128 \
        + x_item * x_rows * n + y_item * rows * n
    return _bound(per * nnz * n, nbytes, peak or peaks[0], peaks[1])
