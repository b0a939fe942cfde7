"""The vector recurrence of a GF Lanczos chain step on the card: the
wrappers of ``csrc/lanczos_chain.cu`` and their launch counter.

After the H·v of a step of :func:`.lanczos._tridiag` gives ``w = H v``:

    α = Re⟨v|w⟩;  w ← w − α v − β' p;  β = ‖w‖;
    v' = w / β, or 0 where β ≤ 1e-200

in three launches (``chain_dot``, ``chain_update``, ``chain_scale``) that
read α and β' from, and write α and β to, the chain's device arrays, and
turn ``w`` into ``v'`` in place.  The plain version is the torch
expressions of ``_tridiag`` itself, which a tensor on the CPU takes.  A
complex chain runs the real kernels on the (re, im) view of its vectors
at twice the length: α and β are real, and Re⟨v|w⟩ is the real dot of
the two views.  Replaces no TPU kernel (the JAX package leaves the
recurrence to XLA inside its lax.scan).
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .split import real_dtype

# Kernel launches in this process (three a chain step).
launches = 0
_entries = {}   # the C entry points, typed once at first use
_SUFFIX = {torch.float64: "f64", torch.complex128: "f64",
           torch.float32: "f32", torch.complex64: "f32"}
_P = ctypes.c_void_p
_ARGTYPES = {
    "dot": [_P] * 5 + [ctypes.c_int, ctypes.c_longlong, _P],
    "update": [_P] * 8 + [ctypes.c_int, ctypes.c_longlong, _P],
    "scale": [_P] * 3 + [ctypes.c_int, ctypes.c_longlong, _P],
}


def _kernel(kind: str, suffix: str):
    """The C entry point ``chain_<kind>_<suffix>``, with its C types."""
    entry = f"chain_{kind}_{suffix}"
    fn = _entries.get(entry)
    if fn is None:
        fn = getattr(build.load("lanczos_chain"), entry)
        fn.argtypes = _ARGTYPES[kind]
        fn.restype = ctypes.c_int
        _entries[entry] = fn
    return fn, entry


def _max_blocks() -> int:
    """Partial sums per row that a launch may write (the kernel's cap on
    blocks per row)."""
    fn = _entries.get("chain_max_blocks")
    if fn is None:
        fn = build.load("lanczos_chain").chain_max_blocks
        fn.argtypes, fn.restype = [], ctypes.c_int
        _entries["chain_max_blocks"] = fn
    return fn()


def _real_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` [B, n] as the real [B, n] or [B, 2n] view the kernels take."""
    return torch.view_as_real(x).reshape(x.shape[0], -1) if x.is_complex() \
        else x


class Chain:
    """The kernels of one chain whose vectors are like ``v`` [B, n] (a
    contiguous float32, float64, complex64 or complex128 CUDA tensor),
    and what their launches share: the per-block partial sums and the
    rows' arrival counters, the rows' sums of squares ``sq`` [B] (f64;
    a sharded chain sums them over its ranks before :meth:`scale`), the
    stream and the device."""

    def __init__(self, v: torch.Tensor):
        if v.device.type != "cuda":
            raise ValueError(f"chain: unsupported device {v.device}")
        if v.dim() != 2 or v.dtype not in _SUFFIX:
            raise TypeError(f"chain: vectors must be [B, n] float32, "
                            f"float64, complex64 or complex128, got "
                            f"{v.dtype} {tuple(v.shape)}")
        self.device, self.dtype = v.device, v.dtype
        self.shape = tuple(v.shape)
        self.rows, self.n = _real_rows(v).shape
        suffix = _SUFFIX[v.dtype]
        self._dot, self._update, self._scale = (
            _kernel(k, suffix) for k in ("dot", "update", "scale"))
        nb = _max_blocks()
        self.part = torch.empty(self.rows * nb, dtype=torch.float64,
                                device=v.device)
        self.cnt = torch.zeros(self.rows, dtype=torch.int32, device=v.device)
        self.sq = torch.empty(self.rows, dtype=torch.float64, device=v.device)
        with torch.cuda.device(v.device):
            self.stream = torch.cuda.current_stream(v.device).cuda_stream

    def _rows(self, name: str, x: torch.Tensor) -> int:
        """The data pointer of vector ``x``'s real view, checked."""
        if x.dtype != self.dtype or tuple(x.shape) != self.shape \
                or x.device != self.device:
            raise ValueError(f"chain: {name} is {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}, "
                             f"{self.dtype} {self.shape} on {self.device} "
                             f"expected")
        if not x.is_contiguous() or x.is_conj():
            raise ValueError(f"chain: {name} must be contiguous, without a "
                             f"lazy conjugation")
        return x.data_ptr()

    def _slot(self, name: str, t: torch.Tensor) -> int:
        """The data pointer of the [B] real array ``t`` (an α or β slot),
        checked."""
        want = real_dtype(self.dtype)
        if t.dtype != want or tuple(t.shape) != self.shape[:1] \
                or t.device != self.device or not t.is_contiguous():
            raise ValueError(f"chain: {name} must be a contiguous "
                             f"{want} [{self.shape[0]}] on "
                             f"{self.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        return t.data_ptr()

    def _launch(self, kernel, *args) -> None:
        global launches
        fn, entry = kernel
        with torch.cuda.device(self.device):
            err = fn(*args, self.rows, self.n, self.stream)
        if err != 0:
            raise RuntimeError(f"{entry}: launch failed with cudaError "
                               f"{err}")
        launches += 1

    def dot(self, v: torch.Tensor, w: torch.Tensor,
            alpha: torch.Tensor) -> None:
        """alpha [B] ← Re⟨v_b|w_b⟩ (this rank's rows)."""
        self._launch(self._dot, self._rows("v", v), self._rows("w", w),
                     self._slot("alpha", alpha), self.part.data_ptr(),
                     self.cnt.data_ptr())

    def update(self, w: torch.Tensor, v: torch.Tensor, p,
               alpha: torch.Tensor, beta_prev) -> None:
        """w ← w − alpha v − beta_prev p in place, and ``sq`` [B] ← ‖w_b‖²
        (this rank's rows); ``p`` and ``beta_prev`` are None on a chain's
        first step (p zero)."""
        if (p is None) != (beta_prev is None):
            raise ValueError("chain: p and beta_prev go together")
        self._launch(self._update, self._rows("w", w), self._rows("v", v),
                     None if p is None else self._rows("p", p),
                     self._slot("alpha", alpha),
                     None if beta_prev is None
                     else self._slot("beta_prev", beta_prev),
                     self.sq.data_ptr(), self.part.data_ptr(),
                     self.cnt.data_ptr())

    def scale(self, w: torch.Tensor, beta: torch.Tensor) -> None:
        """beta [B] ← √sq and w ← w / beta in place (zeros where beta ≤
        1e-200)."""
        self._launch(self._scale, self._rows("w", w), self.sq.data_ptr(),
                     self._slot("beta", beta))
