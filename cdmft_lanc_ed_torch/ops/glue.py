"""The H·v glue of the large kits around their two block-sparse SpMMs: the
wrappers of ``csrc/large_glue.cu``, their plain versions and their launch
counter.

For a batch x [bb, ddp, dup] on a large sector's padded (dw, up) grid,
:func:`.large.apply_large_real_flat_batched` computes

    y_dw = H_dw · xdw,  xdw [ddp, dup·bb],  xdw[d, u·bb + b] = x[b, d, u]
    y_up = H_up · xt,   xt  [dup, ddp·bb],  xt[u, d·bb + b]  = x[b, d, u]
    out[b, d, u] = diag[d, u]·x[b, d, u] + y_dw[d, u·bb + b]
                   + y_up[u, d·bb + b]

:func:`pack` makes xt and xdw (at bb = 1 xdw is x itself), and
:func:`combine` makes out, in that order of operations and rounding.  A
complex vector (complex64 or complex128) takes the real diagonal on both
parts of each element.  A tensor on the CPU takes the plain versions,
:func:`pack_ref` and :func:`combine_ref` (the torch expressions); a CUDA
tensor launches the kernel (``glue_pack``, ``glue_combine``) or raises,
and its result equals the plain version's.
Replaces no TPU kernel (the JAX package leaves the glue to XLA).
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .split import real_dtype

# Kernel launches in this process (two an H·v: pack, combine).
launches = 0
_entries = {}   # the C entry points, typed once at first use
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.complex64: "c64", torch.complex128: "c128"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {"pack": [_P] * 3 + [_I, _L, _L, _P],
             "combine": [_P] * 5 + [_I, _L, _L, _P]}


def _launch(kind: str, x: torch.Tensor, *args) -> None:
    """Launch ``glue_<kind>`` for the type of ``x`` on its stream."""
    global launches
    entry = f"glue_{kind}_{_SUFFIX[x.dtype]}"
    fn = _entries.get(entry)
    if fn is None:
        fn = getattr(build.load("large_glue"), entry)
        fn.argtypes = _ARGTYPES[kind]
        fn.restype = ctypes.c_int
        _entries[entry] = fn
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: launch failed with cudaError {err}")
    launches += 1


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> int:
    """The data pointer of operand ``t``, checked."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device:
        raise ValueError(f"glue: {name} is {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}, {dtype} {tuple(shape)} on {device} "
                         f"expected")
    if not t.is_contiguous() or t.is_conj():
        raise ValueError(f"glue: {name} must be contiguous, without a lazy "
                         f"conjugation")
    return t.data_ptr()


def _cuda_x(x3: torch.Tensor) -> None:
    if x3.device.type != "cuda":
        raise ValueError(f"glue: unsupported device {x3.device}")
    if x3.dim() != 3 or x3.dtype not in _SUFFIX:
        raise TypeError(f"glue: x must be [bb, ddp, dup] float32, float64, "
                        f"complex64 or complex128, got {x3.dtype} "
                        f"{tuple(x3.shape)}")
    _check("x", x3, x3.dtype, x3.shape, x3.device)


def pack_ref(x3: torch.Tensor):
    """Plain version of :func:`pack`: the torch expressions."""
    bb, ddp, dup = x3.shape
    xt = x3.permute(2, 1, 0).reshape(dup, ddp * bb).contiguous()
    xdw = x3[0] if bb == 1 else x3.permute(1, 2, 0).reshape(ddp, dup * bb)
    return xt, xdw


def combine_ref(diag: torch.Tensor, x3: torch.Tensor, y_dw: torch.Tensor,
                y_up: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`combine`: the torch expressions."""
    bb, ddp, dup = x3.shape
    out = diag[None] * x3
    out += y_dw.reshape(ddp, dup, bb).permute(2, 0, 1)
    out += y_up.reshape(dup, ddp, bb).permute(2, 1, 0)
    return out


def pack(x3: torch.Tensor):
    """(xt [dup, ddp·bb], xdw [ddp, dup·bb]) of x3 [bb, ddp, dup], both
    contiguous; xdw is the view ``x3[0]`` at bb = 1."""
    if x3.device.type == "cpu":
        return pack_ref(x3)
    _cuda_x(x3)
    bb, ddp, dup = x3.shape
    xt = torch.empty(dup, ddp * bb, dtype=x3.dtype, device=x3.device)
    xdw = x3[0] if bb == 1 else torch.empty(ddp, dup * bb, dtype=x3.dtype,
                                            device=x3.device)
    _launch("pack", x3, x3.data_ptr(), xt.data_ptr(),
            None if bb == 1 else xdw.data_ptr(), bb, ddp, dup)
    return xt, xdw


def combine(diag: torch.Tensor, x3: torch.Tensor, y_dw: torch.Tensor,
            y_up: torch.Tensor) -> torch.Tensor:
    """out [bb, ddp, dup] = diag·x3 + y_dw + y_up, with y_dw [ddp, dup·bb]
    and y_up [dup, ddp·bb] in the layouts of :func:`pack` and diag
    [ddp, dup] real."""
    if x3.device.type == "cpu":
        return combine_ref(diag, x3, y_dw, y_up)
    _cuda_x(x3)
    bb, ddp, dup = x3.shape
    dev, dt = x3.device, x3.dtype
    ptrs = (_check("diag", diag, real_dtype(dt), (ddp, dup), dev),
            x3.data_ptr(),
            _check("y_dw", y_dw, dt, (ddp, dup * bb), dev),
            _check("y_up", y_up, dt, (dup, ddp * bb), dev))
    out = torch.empty_like(x3)
    _launch("combine", x3, *ptrs, out.data_ptr(), bb, ddp, dup)
    return out
