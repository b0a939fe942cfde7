"""Device policy of the port.

Entry points take an explicit ``torch.device``.  ``None`` means the card:
without CUDA that raises instead of falling back to the CPU, so a run
never reports CPU numbers as if they came from the card.  Tests pass
``device="cpu"``.
"""
from __future__ import annotations

import torch

_FALLBACK_BYTES = int(2e9)


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is missing); anything else is
    taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        # f32 products run in IEEE f32.  TF32 keeps ~10 mantissa bits and
        # would cap the f32 Krylov stage of ed_precision="mixed" near 1e-3
        # residuals: the trap the JAX package met with the TPU's default
        # single-pass dot (the JAX package's ops/large.py:370-375).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def budget_bytes(device: torch.device, fraction: float = 0.25) -> int:
    """Working-set budget for the chunkers: ``fraction`` of the card's
    memory (floored at 256 MB), or 2 GB on the CPU (the JAX package's
    fallback, so CPU runs chunk like the reference)."""
    if device.type != "cuda":
        return _FALLBACK_BYTES
    _free, total = torch.cuda.mem_get_info(device)
    return max(int(total * fraction), 256 << 20)
