"""fused_real_matvec: the program's fused real H·v (f32, dense spin
factors of a sector whose strings fit ``split.DENSE_FACTOR_MAX``).

A kernel module names the kernel's row in the profiler's trace
(``DEVICE_NAME``), the program's entry point that the traced run wraps
(``ENTRY``), and has ``launches()`` (the program's own count so far),
``launch(args, kwargs, peaks)`` ((shape, least seconds) of one call on the
card, None off it) and ``warm(dims, options, device)`` (one call at each
shape that sectors of (up, down) dimensions ``dims`` use).
"""
from __future__ import annotations

import bounds

DEVICE_NAME = "fused_real_matvec_kernel"
ENTRY = ("cdmft_lanc_ed_torch.ops.fused", "fused_real_matvec")


def launches() -> int:
    from cdmft_lanc_ed_torch.ops import fused
    return fused.launches


def launch(args, kwargs, peaks):
    x = args[3] if len(args) > 3 else kwargs["x"]
    if x.device.type != "cuda":
        return None
    b = x.shape[0] if x.dim() == 3 else 1
    d, u = x.shape[-2:]
    return (b, d, u), bounds.fused_real_bound_s(b, d, u, peaks)[0]


def dense_shapes(dims):
    """The padded (D, U) of each sector of ``dims`` that takes dense
    factors."""
    from cdmft_lanc_ed_torch.ops.split import DENSE_FACTOR_MAX, _bucket
    return sorted({(_bucket(dd), _bucket(du)) for du, dd in dims
                   if max(du, dd) <= DENSE_FACTOR_MAX})


def warm(dims, options, device, dtype="float32", refine="float64",
         kernel=None):
    """One launch at each dense shape, and the refine's plain product
    there."""
    import torch
    from cdmft_lanc_ed_torch.ops import fused
    kernel = kernel or fused.fused_real_matvec
    lo, hi = getattr(torch, dtype), getattr(torch, refine)
    for d, u in dense_shapes(dims):
        kernel(torch.zeros(d, u, device=device, dtype=torch.float32),
               torch.zeros(d, d, device=device, dtype=lo),
               torch.zeros(u, u, device=device, dtype=lo),
               torch.zeros(d, u, device=device, dtype=lo))
        torch.zeros(d, d, device=device, dtype=hi) @ \
            torch.zeros(d, u, device=device, dtype=hi)
