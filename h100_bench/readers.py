"""What the metric readers under ``metrics/`` share: stage seconds per
solve, kernel rooflines from the trace or from the launch events, and the
device's idle share, each checked against the program's own counters.

A kernel is named as in the configuration's ``kernels`` and
``kernels/<name>.py``; ``run.counters["launches"][name]`` is the
program's own count of its launches over the window.
"""
from __future__ import annotations

from typing import Optional


def stage_per_solve(run, stage: str) -> Optional[float]:
    """Mean seconds of the solver's stage timer ``stage`` over the
    window's solves."""
    vals = [s["stages"][stage] for s in run.solves if stage in s["stages"]]
    return sum(vals) / len(vals) if vals else None


def counted(run, kernel: str) -> int:
    return run.counters["launches"].get(kernel, 0)


def traced_complete(run, kernel: str) -> bool:
    """Whether the trace holds every launch of ``kernel`` that the
    program counted in the window."""
    return run.trace is not None and \
        run.trace.kernel(run.kernels[kernel].DEVICE_NAME)[0] == \
        counted(run, kernel)


def kernel_seconds(run, kernel: str) -> Optional[float]:
    """The kernel's device seconds over the window: from the trace when it
    holds every counted launch, else from the CUDA events around each
    launch when those are complete; None otherwise."""
    n = counted(run, kernel)
    if kernel not in run.kernels or n == 0:
        return None
    fragment = run.kernels[kernel].DEVICE_NAME
    if traced_complete(run, kernel):
        run.notes.append(f"{kernel}: {n} launches, time from the trace")
        return run.trace.kernel(fragment)[1]
    own = [ln for ln in run.launches if ln.kernel == kernel]
    traced = run.trace.kernel(fragment)[0] if run.trace else None
    if len(own) == n:
        run.notes.append(f"{kernel}: trace holds {traced} of {n} launches; "
                         f"time from CUDA events around each launch")
        return sum(ln.seconds() for ln in own)
    run.notes.append(f"{kernel}: {n} launches counted, {traced} traced, "
                     f"{len(own)} recorded: no time")
    return None


def kernel_roofline(run, kernel: str) -> Optional[float]:
    """Σ bound / Σ device time, in %, over the window's launches of
    ``kernel``; each launch's bound from its type and shapes as recorded
    around it (``kernels/<name>.py``), only when every counted launch was
    recorded."""
    t = kernel_seconds(run, kernel)
    own = [ln for ln in run.launches if ln.kernel == kernel]
    if not t or len(own) != counted(run, kernel):
        return None
    return 100.0 * sum(ln.bound_s for ln in own) / t


def device_idle(run) -> Optional[float]:
    """100·(1 - busy / window) of the traced window, only from a trace
    that holds every counted launch of each kernel the configuration
    names."""
    if run.trace is None or not all(traced_complete(run, k)
                                    for k in run.kernels):
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
