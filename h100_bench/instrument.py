"""What the traced run adds around the program, from the benchmark's side:
spans (``torch.profiler.record_function``) around the calls into each
layer, and a record of every launch of each kernel that the
configuration names (``kernels/<name>.py``), with CUDA events around it
(the kernel's type and shapes, for its bound; the events, for a time that
does not depend on the profiler).

Each wrapper replaces a module attribute that the program looks up at
call time and is removed again by :meth:`Instruments.remove`; a name the
program no longer has is skipped.
"""
from __future__ import annotations

import functools
import importlib
from typing import Callable, Dict, List

import torch

from devtrace import SPAN_PREFIX

# (module, attribute, span): the host calls into each layer
SPANS = (
    ("cdmft_lanc_ed_torch.solver", "diagonalize_impurity", "diag"),
    ("cdmft_lanc_ed_torch.solver", "build_gf_and_sigma", "gf"),
    ("cdmft_lanc_ed_torch.solver", "observables_impurity", "observables"),
    ("cdmft_lanc_ed_torch.solver", "local_energy_impurity", "observables"),
    ("cdmft_lanc_ed_torch.ops.sector_ham", "build_sector_operator",
     "diag.sector_build"),
    ("cdmft_lanc_ed_torch.diag", "_solve_batched", "diag.batched"),
    ("cdmft_lanc_ed_torch.diag", "_solve_serial", "diag.serial"),
    ("cdmft_lanc_ed_torch.diag", "_solve_large", "diag.large"),
    ("cdmft_lanc_ed_torch.gf", "build_gf_normal", "gf.chains"),
    ("cdmft_lanc_ed_torch.gf", "evaluate_gf_nnn", "gf.evaluate"),
    ("cdmft_lanc_ed_torch.ops.lanczos", "tridiag_eigh", "lanczos.host_eigh"),
    ("cdmft_lanc_ed_torch.ops.lanczos", "dense_eigh", "lanczos.host_eigh"),
    ("cdmft_lanc_ed_torch.io", "print_impsigma", "io"),
    ("cdmft_lanc_ed_torch.io", "print_impg", "io"),
    ("cdmft_lanc_ed_torch.io", "print_impg0", "io"),
    ("cdmft_lanc_ed_torch.io", "write_observables", "io"),
    ("cdmft_lanc_ed_torch.io", "write_energy", "io"),
    ("cdmft_lanc_ed_torch.io", "write_zeta_and_sig", "io"),
)

class Launch:
    """One kernel launch: its kernel, what sets its bound, and CUDA events
    before and after it."""
    __slots__ = ("kernel", "shape", "bound_s", "start", "end")

    def __init__(self, kernel, shape, bound_s):
        self.kernel, self.shape, self.bound_s = kernel, shape, bound_s
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def seconds(self) -> float:
        return self.start.elapsed_time(self.end) * 1e-3


class Instruments:
    """Spans around the program's layers, and a :class:`Launch` around
    every call of each kernel module's ``ENTRY`` that reaches the card."""

    def __init__(self, peaks, kernels: Dict[str, object]):
        self.peaks = peaks
        self.kernels = kernels
        self.launches: List[Launch] = []
        self._undo: List[Callable[[], None]] = []

    def _patch(self, module: str, attr: str, make):
        try:
            mod = importlib.import_module(module)
        except ImportError:
            return
        orig = getattr(mod, attr, None)
        if orig is None:
            return
        setattr(mod, attr, make(orig))
        self._undo.append(lambda: setattr(mod, attr, orig))

    def install(self) -> "Instruments":
        for module, attr, span in SPANS:
            self._patch(module, attr, lambda f, s=span: _spanned(f, s))
        for name, kmod in self.kernels.items():
            self._patch(*kmod.ENTRY,
                        lambda f, n=name, k=kmod: self._timed(f, n, k))
        return self

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()

    def _timed(self, f, name: str, kmod):
        @functools.wraps(f)
        def inner(*a, **kw):
            info = kmod.launch(a, kw, self.peaks)
            if info is None:
                return f(*a, **kw)
            launch = Launch(name, *info)
            launch.start.record()
            out = f(*a, **kw)
            launch.end.record()
            self.launches.append(launch)
            return out
        return inner


def _spanned(f, span: str):
    name = SPAN_PREFIX + span

    @functools.wraps(f)
    def inner(*a, **kw):
        with torch.profiler.record_function(name):
            return f(*a, **kw)
    return inner
