"""Wall-clock stage timers (the reference's SF_TIMER around
diagonalization, GF build and observables).  Each stage ends in a host
read of its results, so the host clock covers the device work."""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional


class Timers:
    def __init__(self, log: Optional[Callable[[str], None]] = None):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.log = log or (lambda s: None)

    @contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self.log(f"[timer] {name}: {dt:.3f}s "
                     f"(total {self.totals[name]:.3f}s "
                     f"x{self.counts[name]})")

    def write(self, path: str) -> None:
        try:
            with open(path, "w") as fh:
                for name in sorted(self.totals):
                    fh.write(f"{name} {self.totals[name]:.6f} "
                             f"{self.counts[name]}\n")
        except OSError:
            pass
