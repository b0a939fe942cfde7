"""blk_spmm: the program's block-sparse SpMM (128x128 tiles read in a
compact form) of sectors whose strings exceed ``split.DENSE_FACTOR_MAX``;
see ``fused_real_matvec.py`` for what a kernel module holds.  Options:
``types``, the instantiations the configuration's solves launch (f32,
bf16, f64 for a real Hamiltonian; c64, bf16c, c128 for a complex one)."""
from __future__ import annotations

import bounds

DEVICE_NAME = "blk_spmm_kernel"
ENTRY = ("cdmft_lanc_ed_torch.ops.large", "blk_spmm")


def _kind(tiles) -> str:
    import torch
    if tiles.dim() == 4:
        return "bf16c"
    return {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.float64: "f64", torch.complex64: "c64",
            torch.complex128: "c128"}[tiles.dtype]


def launches() -> int:
    from cdmft_lanc_ed_torch.ops import large
    return large.launches


def launch(args, kwargs, peaks):
    rb, cb, tiles, x, nb_out = args[:5]
    index = kwargs.get("index", args[5] if len(args) > 5 else None)
    if x.device.type != "cuda":
        return None
    kind = _kind(tiles)
    if index is not None:
        nnz = index[1].numel()
        vals = index[2].numel() * index[2].element_size()
    else:
        nz = tiles != 0
        nnz = int((nz.any(-1) if kind == "bf16c" else nz).sum())
        vals = nnz * tiles.element_size() * (2 if kind == "bf16c" else 1)
    rows, n = nb_out * 128, x.shape[1]
    return (kind, nnz, rows, n), bounds.blk_bound_s(
        kind, nnz, rows, n, x.shape[0], vals, peaks)[0]


def warm(dims, options, device):
    """One launch of each of ``options["types"]`` on a one-tile factor,
    if any sector of ``dims`` takes block-sparse factors."""
    import torch
    from cdmft_lanc_ed_torch.ops import large
    from cdmft_lanc_ed_torch.ops.split import DENSE_FACTOR_MAX
    if not any(max(du, dd) > DENSE_FACTOR_MAX for du, dd in dims):
        return
    zero = torch.zeros(1, dtype=torch.int32, device=device)
    eye = torch.eye(128, device=device)
    for kind in options["types"]:
        if kind == "bf16c":
            tiles = torch.stack([eye, 0 * eye], -1).to(torch.bfloat16)[None]
            x = torch.ones(128, 8, device=device, dtype=torch.complex64)
        else:
            dt = {"f32": torch.float32, "bf16": torch.bfloat16,
                  "f64": torch.float64, "c64": torch.complex64,
                  "c128": torch.complex128}[kind]
            tiles = eye.to(dt)[None]
            x = torch.ones(128, 8, device=device,
                           dtype=torch.float32 if kind == "bf16" else dt)
        large.blk_spmm(zero, zero, tiles, x, 1)
