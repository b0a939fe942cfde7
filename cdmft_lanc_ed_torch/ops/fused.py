"""Fused tensor-product sector H·v: the CUDA kernels' wrappers, their
plain versions and their launch counters.

    out = diag ⊙ X + H_dw · X + X · H_upᵀ

Ports of the two TPU kernels of the JAX package's ``ops/pallas_fused.py``:
``fused_real_matvec`` (f32, ``csrc/fused_real_matvec.cu``) and
``fused_pair_matvec`` (complex64, ``csrc/fused_pair_matvec.cu``).  They are
the H·v of the f32 Krylov stage of ``ed_precision="mixed"`` for real and
for complex sector Hamiltonians.  A tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

# Kernel launches in this process (one per call that reached the card):
# ``launches`` counts the real kernel, ``pair_launches`` the complex one.
launches = 0
pair_launches = 0
_entries = {}   # the C entry points, typed once at first use


def fused_real_matvec_ref(diag: torch.Tensor, hdw: torch.Tensor,
                          hupT: torch.Tensor, x: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version: diag * x + hdw @ x + x @ hupT (broadcast
    over leading batch axes)."""
    return diag * x + hdw @ x + x @ hupT


def fused_pair_matvec_ref(diag: torch.Tensor, hdw: torch.Tensor,
                          hupT: torch.Tensor, x: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version of the complex kernel: diag * x + hdw @ x +
    x @ hupT in complex64 (diag real; broadcast over leading batch
    axes)."""
    return diag * x + hdw @ x + x @ hupT


def _batch_stride(fn: str, t: torch.Tensor, nbatch: int, name: str) -> int:
    """Elements between consecutive batch members of an operand: 0 for an
    unbatched [n, m] operand shared by the batch."""
    if t.dim() == 2:
        return 0
    if t.dim() == 3 and t.shape[0] == nbatch:
        return t.shape[1] * t.shape[2]
    raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, batch "
                     f"{nbatch} expected")


def _check(fn: str, diag, hdw, hupT, x, dtype) -> tuple:
    """Shapes, types and devices of one call of kernel ``fn``: diag is
    float32, the other operands ``dtype``.  Returns (D, U, B)."""
    if x.dim() not in (2, 3):
        raise ValueError(f"{fn}: x must be [D, U] or [B, D, U], got "
                         f"{tuple(x.shape)}")
    d, u = x.shape[-2:]
    nb = x.shape[0] if x.dim() == 3 else 1
    for name, t, want, ty in (("diag", diag, (d, u), torch.float32),
                              ("hdw", hdw, (d, d), dtype),
                              ("hupT", hupT, (u, u), dtype)):
        if tuple(t.shape[-2:]) != want:
            raise ValueError(f"{fn}: {name} trailing shape "
                             f"{tuple(t.shape[-2:])} != {want}")
        if t.dim() == 3 and x.dim() == 2:
            raise ValueError(f"{fn}: batched {name} with an unbatched x")
        if t.dtype != ty:
            raise TypeError(f"{fn}: {name} is {t.dtype}, {ty} expected")
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} on {t.device}, x on "
                             f"{x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{fn}: x is {x.dtype}, {dtype} expected")
    return d, u, nb


def _kernel(name: str, entry: str):
    """The C entry point ``entry`` of kernel ``name``, with its C types."""
    fn = _entries.get(entry)
    if fn is None:
        fn = getattr(build.load(name), entry)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[entry] = fn
    return fn


def _launch(fn: str, entry: str, diag, hdw, hupT, x, d, u, nb
            ) -> torch.Tensor:
    """Launch kernel ``fn`` on CUDA tensors; raises on anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    for name, t in (("diag", diag), ("hdw", hdw), ("hupT", hupT),
                    ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
        if t.is_conj():
            raise ValueError(f"{fn}: {name} carries a lazy conjugation "
                             f"(call resolve_conj first)")
    strides = [_batch_stride(fn, t, nb, n) for n, t in
               (("diag", diag), ("hdw", hdw), ("hupT", hupT))]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel(fn, entry)(diag.data_ptr(), hdw.data_ptr(),
                                 hupT.data_ptr(), x.data_ptr(),
                                 out.data_ptr(), nb, d, u, *strides, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with cudaError {err}")
    return out


def fused_real_matvec(diag: torch.Tensor, hdw: torch.Tensor,
                      hupT: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out = diag ⊙ x + hdw @ x + x @ hupT in f32.

    x: [D, U] or [B, D, U]; diag: [D, U] or [B, D, U]; hdw: [D, D] or
    [B, D, D]; hupT: [U, U] or [B, U, U].  An unbatched operand is shared
    by every batch member."""
    global launches
    fn = "fused_real_matvec"
    d, u, nb = _check(fn, diag, hdw, hupT, x, torch.float32)
    if x.device.type == "cpu":
        return fused_real_matvec_ref(diag, hdw, hupT, x)
    out = _launch(fn, "fused_real_matvec_f32", diag, hdw, hupT, x, d, u, nb)
    launches += 1
    return out


def fused_pair_matvec(diag: torch.Tensor, hdw: torch.Tensor,
                      hupT: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out = diag ⊙ x + hdw @ x + x @ hupT in complex64, diag float32.

    Shapes as :func:`fused_real_matvec`; hupT is H_upᵀ, the transpose of
    the spin-up factor (not its conjugate transpose)."""
    global pair_launches
    fn = "fused_pair_matvec"
    d, u, nb = _check(fn, diag, hdw, hupT, x, torch.complex64)
    if x.device.type == "cpu":
        return fused_pair_matvec_ref(diag, hdw, hupT, x)
    out = _launch(fn, "fused_pair_matvec_c64", diag, hdw, hupT, x, d, u, nb)
    pair_launches += 1
    return out
