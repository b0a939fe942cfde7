"""The operator kit of a sector: the device operator an eigensolve or a
GF chain runs on, and the H·v that applies it.

Every choice of kit is made here, above ``ops/`` and ``parallel/`` and
below ``diag`` and ``gf``:

=====================================  ================================
sector and vectors                     kit and applier
=====================================  ================================
dense, real operator, real vectors     ``split.apply_real_flat``
dense, real operator, complex vectors  ``split.apply_realpair_flat``
dense, complex operator                ``split.apply_pair_flat``
large (a factor > DENSE_FACTOR_MAX)    the tile kit (``ops/large.py``)
on a "dw" mesh, dim >= ``shard_from``  the sharded tile kit
                                       (``parallel/sharded_large.py``)
=====================================  ================================

The tile kits keep real tiles for a real operator, which take complex
vectors as they are.  An eigensolve applies them to one vector at a time
(the refine's blocks row by row); a GF chain batch is folded into the
SpMM width (``fold``).  Same-bucket dense sectors solved as one batch
take the stacked operators of :func:`stacked`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .ops import large, split
from .ops.sector_ham import SectorOperator
from .parallel import multichip, sharded_large


@dataclass
class Kit:
    """A sector's device operator ``dev`` and what runs on it:
    ``apply(dev, x)`` maps flat rows x [..., dim_p] to H·x; ``embed`` and
    ``extract`` take whole vectors [..., dim] (host arrays or tensors) to
    those rows and back; ``vectors`` is the rows' dtype and ``real`` says
    whether the operator is.  ``coarse()``, on the one-card tile kit
    only, builds the operator's bf16 tiles on its structure (the coarse
    Krylov stage)."""
    dev: object
    apply: Callable
    real: bool
    vectors: torch.dtype
    dim_p: int
    embed: Callable
    extract: Callable
    coarse: Optional[Callable] = None


def is_large(op: SectorOperator) -> bool:
    """True when a spin factor exceeds the dense-factor limit."""
    return max(op.dim_up, op.dim_dw) > split.DENSE_FACTOR_MAX


def large_sector(ns: int, nup: int, ndw: int) -> bool:
    """:func:`is_large` of sector (nup, ndw) without building it."""
    return max(math.comb(ns, nup), math.comb(ns, ndw)) \
        > split.DENSE_FACTOR_MAX


def eig_shard_from(cfg) -> int:
    """Dimension from which an eigensolve runs on the sharded tile kit
    when a "dw" mesh is installed: 64·lanc_dim_threshold (the JAX
    package's diag.py:432-437).  The GF chains shard the large sectors
    only (``shard_from=0`` on a large target)."""
    return 64 * cfg.lanc_dim_threshold


def sharded(dim: int, shard_from: Optional[int]) -> bool:
    """True when a sector of ``dim`` takes the sharded tile kit: a mesh
    with a "dw" axis is installed and dim >= ``shard_from``."""
    return shard_from is not None and dim >= shard_from and \
        multichip.has_axis(multichip.get_solver_mesh(), "dw")


def kit_for(op: SectorOperator, dtype, device, *,
            complex_vectors: bool = False,
            shard_from: Optional[int] = None, fold: bool = False,
            reuse: Optional[Kit] = None) -> Kit:
    """The kit of ``op`` at precision ``dtype`` (float32 or float64; a
    complex operator or ``complex_vectors`` takes complex64 /
    complex128 vectors).  ``reuse``: the float32 kit of the same sector,
    whose block indices and structures a sharded build shares (the other
    kits are built anew: a one-card tile kit's f64 diagonal is its
    own)."""
    real = split.op_is_real(op)
    vectors = dtype if real and not complex_vectors \
        else split.complex_dtype(dtype)
    if sharded(op.dim, shard_from):
        build = sharded_large.build_sharded_large_real if real \
            else sharded_large.build_sharded_large_pair
        dev = build(op, multichip.get_solver_mesh(), dtype=dtype,
                    reuse=None if reuse is None else reuse.dev,
                    device=device)
        return Kit(dev, sharded_large.apply_sharded_large_real_flat_batched
                   if fold else sharded_large.apply_sharded_large_real_flat,
                   real, vectors, dev.ddp // dev.ndw * dev.dup,
                   lambda v: sharded_large.shard_rows(dev, v),
                   lambda v: sharded_large.gather_vector(dev, v))
    dd, du = op.dim_dw, op.dim_up
    coarse = None
    if is_large(op):
        to_dev = large.to_device_large_real if real \
            else large.to_device_large_pair
        dev = to_dev(op, dtype=dtype, device=device)
        apply = large.apply_large_real_flat_batched if fold \
            else large.apply_large_real_flat
        ddp, dup = dev.diag.shape

        def coarse():
            return to_dev(op, dtype=torch.bfloat16, reuse=dev, device=device)
    else:
        ddp, dup = split._bucket(dd), split._bucket(du)
        dev = (split.to_device_dense_real if real
               else split.to_device_dense_split)(
            op, pad_to=(ddp, dup) if (ddp, dup) != (dd, du) else None,
            dtype=dtype, device=device)
        apply = split.apply_pair_flat if not real else \
            split.apply_realpair_flat if complex_vectors \
            else split.apply_real_flat
    return Kit(dev, apply, real, vectors, ddp * dup,
               lambda v: split.embed_real(v, dd, du, ddp, dup),
               lambda v: split.extract_real(v, dd, du, ddp, dup), coarse)


def stacked(ops, bucket: tuple, real: bool, dtype, device):
    """The stacked dense operator of same-bucket sectors ``ops`` of one
    kind (a leading batch axis; apply it with :func:`stacked_apply`)."""
    stack = split.stack_real_ops if real else split.stack_pair_ops
    return stack(ops, bucket, dtype=dtype, device=device)


def stacked_apply(real: bool) -> Callable:
    """The applier of :func:`stacked`'s operators: the dense appliers
    broadcast over the batch axis."""
    return split.apply_real_flat if real else split.apply_pair_flat
