"""fused_pair_matvec: the program's fused complex H·v (complex64, real
f32 diag, dense spin factors); see ``fused_real_matvec.py`` for what a
kernel module holds."""
from __future__ import annotations

import bounds
from kernels.fused_real_matvec import warm as _warm_dense

DEVICE_NAME = "fused_pair_matvec_kernel"
ENTRY = ("cdmft_lanc_ed_torch.ops.fused", "fused_pair_matvec")


def launches() -> int:
    from cdmft_lanc_ed_torch.ops import fused
    return fused.pair_launches


def launch(args, kwargs, peaks):
    x = args[3] if len(args) > 3 else kwargs["x"]
    if x.device.type != "cuda":
        return None
    b = x.shape[0] if x.dim() == 3 else 1
    d, u = x.shape[-2:]
    return (b, d, u), bounds.fused_pair_bound_s(b, d, u, peaks)[0]


def warm(dims, options, device):
    from cdmft_lanc_ed_torch.ops import fused
    _warm_dense(dims, options, device, "complex64", "complex128",
                fused.fused_pair_matvec)
