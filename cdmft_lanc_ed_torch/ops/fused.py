"""Fused real tensor-product sector H·v: the CUDA kernel's wrapper, its
plain version and its launch counter.

    out = diag ⊙ X + H_dw · X + X · H_upᵀ

Port of the TPU kernel of the JAX package, ``ops/pallas_fused.py::
fused_real_matvec``; the kernel is ``csrc/fused_real_matvec.cu``.  It is
the f32 H·v of the Krylov stage of ``ed_precision="mixed"``.  A tensor on
the CPU takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

# Kernel launches in this process (one per call that reached the card).
launches = 0
_entry = None   # the C entry point, typed once at first use


def fused_real_matvec_ref(diag: torch.Tensor, hdw: torch.Tensor,
                          hupT: torch.Tensor, x: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version: diag * x + hdw @ x + x @ hupT (broadcast
    over leading batch axes)."""
    return diag * x + hdw @ x + x @ hupT


def _batch_stride(t: torch.Tensor, nbatch: int, name: str) -> int:
    """Elements between consecutive batch members of an operand: 0 for an
    unbatched [n, m] operand shared by the batch."""
    if t.dim() == 2:
        return 0
    if t.dim() == 3 and t.shape[0] == nbatch:
        return t.shape[1] * t.shape[2]
    raise ValueError(f"fused_real_matvec: {name} has shape "
                     f"{tuple(t.shape)}, batch {nbatch} expected")


def _check(diag, hdw, hupT, x) -> tuple:
    if x.dim() not in (2, 3):
        raise ValueError(f"fused_real_matvec: x must be [D, U] or "
                         f"[B, D, U], got {tuple(x.shape)}")
    d, u = x.shape[-2:]
    nb = x.shape[0] if x.dim() == 3 else 1
    for name, t, want in (("diag", diag, (d, u)), ("hdw", hdw, (d, d)),
                          ("hupT", hupT, (u, u))):
        if tuple(t.shape[-2:]) != want:
            raise ValueError(f"fused_real_matvec: {name} trailing shape "
                             f"{tuple(t.shape[-2:])} != {want}")
        if t.dim() == 3 and x.dim() == 2:
            raise ValueError(f"fused_real_matvec: batched {name} with an "
                             f"unbatched x")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_real_matvec: {name} is {t.dtype}, "
                            f"float32 expected")
        if t.device != x.device:
            raise ValueError(f"fused_real_matvec: {name} on {t.device}, "
                             f"x on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"fused_real_matvec: x is {x.dtype}, float32 "
                        f"expected")
    return d, u, nb


def _kernel():
    """``fused_real_matvec_f32`` of the built library, with its C types."""
    global _entry
    if _entry is None:
        fn = build.load("fused_real_matvec").fused_real_matvec_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def fused_real_matvec(diag: torch.Tensor, hdw: torch.Tensor,
                      hupT: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out = diag ⊙ x + hdw @ x + x @ hupT in f32.

    x: [D, U] or [B, D, U]; diag: [D, U] or [B, D, U]; hdw: [D, D] or
    [B, D, D]; hupT: [U, U] or [B, U, U].  An unbatched operand is shared
    by every batch member."""
    global launches
    d, u, nb = _check(diag, hdw, hupT, x)
    if x.device.type == "cpu":
        return fused_real_matvec_ref(diag, hdw, hupT, x)
    if x.device.type != "cuda":
        raise ValueError(f"fused_real_matvec: unsupported device "
                         f"{x.device}")
    for name, t in (("diag", diag), ("hdw", hdw), ("hupT", hupT),
                    ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"fused_real_matvec: {name} is not contiguous")
    strides = [_batch_stride(t, nb, n) for n, t in
               (("diag", diag), ("hdw", hdw), ("hupT", hupT))]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(diag.data_ptr(), hdw.data_ptr(), hupT.data_ptr(),
                        x.data_ptr(), out.data_ptr(), nb, d, u, *strides,
                        stream)
    if err != 0:
        raise RuntimeError(f"fused_real_matvec: launch failed with "
                           f"cudaError {err}")
    launches += 1
    return out
