"""What the readers of the program's own spans and counters share.

The program records spans and counters inside each solve
(``cdmft_lanc_ed_torch.utils.timer``): while a profiler runs, every solve
ends in ``timer.traced_solves()`` with its spans ``(start_ns, end_ns,
name, parent, attrs)`` on the profiler's clock and its counters; its
span seconds are also in each solve's ``stages`` (the copy of
``solver.timers.totals``).  Every reader here returns None unless the
traced solves inside the traced window number the window's solves: a
program without these records (an older version) reads nothing, and a
partial record is not read as a whole one.
"""
from __future__ import annotations

from typing import List, Optional

from devtrace import gaps, union
from readers import traced_complete


def window_solves(run) -> Optional[List[dict]]:
    """The program's traced solves inside ``run.trace.window``, or None
    when they do not number ``len(run.solves)``."""
    if run.trace is None or not run.solves:
        return None
    try:
        from cdmft_lanc_ed_torch.utils import timer
    except ImportError:
        return None
    traced = getattr(timer, "traced_solves", None)
    if traced is None:
        return None
    lo, hi = run.trace.window
    solves = [s for s in traced() if lo <= s["start_ns"] and
              s["end_ns"] <= hi]
    return solves if len(solves) == len(run.solves) else None


def overlap(a, b) -> int:
    """Length of the intersection of two sorted disjoint interval lists
    [(start, end)]."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under(trace, solves, name: str) -> float:
    """Seconds of device idle inside the trace's window that fall under
    the union of the ``name`` spans of ``solves``."""
    holes = gaps(union(trace.device, trace.window), trace.window)
    spans = union([s for sol in solves for s in sol["spans"]
                   if s[2] == name], trace.window)
    return overlap(holes, spans) * 1e-9


def idle_per_solve(run, name: str) -> Optional[float]:
    """Device-idle seconds under the program's ``name`` spans per solve,
    only from a trace that holds every counted launch of each kernel the
    configuration names (as ``device_idle``)."""
    solves = window_solves(run)
    if solves is None or not all(traced_complete(run, k)
                                 for k in run.kernels):
        return None
    return idle_under(run.trace, solves, name) / len(run.solves)


def span_s_per_solve(run, name: str) -> Optional[float]:
    """Host seconds of the program's ``name`` spans per solve, summed over
    the window's solves (0 for a solve that holds none)."""
    if window_solves(run) is None:
        return None
    return sum(s["stages"].get(name, 0.0) for s in run.solves) \
        / len(run.solves)


def counter_per_solve(run, name: str) -> Optional[float]:
    """The program's counter ``name`` per solve over the window."""
    solves = window_solves(run)
    if solves is None:
        return None
    return sum(s["counters"].get(name, 0) for s in solves) / len(run.solves)
