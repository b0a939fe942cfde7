"""The solver's tracer: spans and counters recorded where the work happens.

Each :meth:`EDSolver.solve` builds a :class:`Timers` and makes it the
active recorder for the solve (:meth:`Timers.active`).  Any layer reaches
it without a handle: ``with span("lanczos.restart"): ...`` adds the
span's host seconds to ``timers.totals[name]`` and one entry to
``timers.counts[name]``; ``count("host_reads")`` adds to
``timers.counters[name]``.  With no solve active both do nothing.  The
four stage spans of a solve (``timers("diagonalization")``, the
reference's SF_TIMER stages) also log a ``[timer]`` line; each stage ends
in a host read of its results, so the host clock covers its device work.

While a profiler is active (``torch.profiler``), each span is also kept
as ``(start_ns, end_ns, name, parent, attrs)`` on ``time.time_ns()``,
the clock of the profiler's own events; ``parent`` is the index of the
enclosing span in the same list, -1 at the top.  At the end of such a
solve its spans, totals and counters go to :func:`traced_solves`, which
copies them when it is read.  Spans
never enter ``record_function`` (the profiler would copy every range
onto the device timeline) and never synchronise the device: untraced, a
span costs two ``perf_counter`` reads and a dict update.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import torch.autograd.profiler as _profiler

# the active solve's recorder
_active: Optional["Timers"] = None
# the newest traced solves, oldest first
_traced: deque = deque(maxlen=64)
_solve_ids = itertools.count(1)


def _profiling() -> bool:
    return _profiler._is_profiler_enabled


class span:
    """``with span(name, **attrs) as sp:`` records the block on the active
    recorder; ``sp.seconds()`` is its host seconds so far (or in all,
    once closed), with or without a recorder."""
    __slots__ = ("name", "attrs", "rec", "t0", "dt", "idx", "log")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs, self.rec = name, attrs, _active
        self.dt = self.idx = None
        self.log = False

    def __enter__(self) -> "span":
        rec = self.rec
        if rec is not None and _profiling():
            self.idx = rec._open(self.name, self.attrs)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.dt = time.perf_counter() - self.t0
        rec = self.rec
        if rec is not None:
            rec.add(self.name, self.dt, log=self.log)
            if self.idx is not None:
                rec._close(self.idx)
        return False

    def seconds(self) -> float:
        return self.dt if self.dt is not None \
            else time.perf_counter() - self.t0


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the active recorder's counter ``name``."""
    rec = _active
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def to_host(t):
    """``t`` as a host numpy array: every explicit device-to-host read of
    the solver's layers goes through here and is counted as
    ``host_reads`` (on the card each one waits for the device)."""
    count("host_reads")
    return t.cpu().numpy()


def traced_solves() -> List[dict]:
    """The newest traced solves (at most 64), oldest first: each a dict
    of ``id``, ``start_ns``, ``end_ns``, ``spans``, ``totals``, ``counts``
    and ``counters``."""
    for i in range(len(_traced)):
        if isinstance(_traced[i], tuple):  # kept as references at its end
            sid, t0, t1, spans, totals, counts, counters = _traced[i]
            _traced[i] = {
                "id": sid, "start_ns": t0, "end_ns": t1,
                "spans": [tuple(s) for s in spans], "totals": dict(totals),
                "counts": dict(counts), "counters": dict(counters)}
    return list(_traced)


class Timers:
    """One solve's spans and counters."""

    def __init__(self, log: Optional[Callable[[str], None]] = None):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.counters: Dict[str, int] = {}
        self.spans: list = []
        self._stack: List[int] = []
        self.log = log or (lambda s: None)

    def __call__(self, name: str) -> span:
        """A stage span: recorded here, and logged when it ends."""
        sp = span(name)
        sp.rec, sp.log = self, True
        return sp

    def add(self, name: str, seconds: float, log: bool = False) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1
        if log:
            self.log(f"[timer] {name}: {seconds:.3f}s "
                     f"(total {self.totals[name]:.3f}s "
                     f"x{self.counts[name]})")

    def _open(self, name: str, attrs: dict) -> int:
        idx = len(self.spans)
        parent = self._stack[-1] if self._stack else -1
        self.spans.append([time.time_ns(), None, name, parent, attrs])
        self._stack.append(idx)
        return idx

    def _close(self, idx: int) -> None:
        self.spans[idx][1] = time.time_ns()
        self._stack.pop()          # spans nest: ``idx`` is the innermost

    @contextmanager
    def active(self):
        """Make this the active recorder for the block (a solve); a block
        that starts under a profiler ends in :func:`traced_solves`."""
        global _active
        prev, _active = _active, self
        traced = _profiling()
        t0 = time.time_ns()
        try:
            yield self
        finally:
            # the end stamp, then only references: a copy of the span
            # list here would lie inside the profiler's range after the
            # stamp (at Ns=12, thousands of tuples and a collection)
            t1 = time.time_ns()
            _active = prev
            if traced:
                _traced.append((next(_solve_ids), t0, t1, self.spans,
                                self.totals, self.counts, self.counters))

    def write(self, path: str) -> None:
        """``name seconds entries`` per span, then ``name value`` per
        counter (an operator's file)."""
        try:
            with open(path, "w") as fh:
                for name in sorted(self.totals):
                    fh.write(f"{name} {self.totals[name]:.6f} "
                             f"{self.counts[name]}\n")
                for name in sorted(self.counters):
                    fh.write(f"{name} {self.counters[name]}\n")
        except OSError:
            pass
