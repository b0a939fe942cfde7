"""Reduction of a ``torch.profiler`` trace to the benchmark's numbers.

The device is busy wherever at least one device operation (kernel,
copy, set) runs: the busy time is the length of the union of their
intervals on the profiler's timeline, not the sum of their durations,
which counts overlapping streams twice.  This corrects the sum that
``chip_smoke.profile_summary`` takes.  Idle gaps are the holes in that
union inside the traced window, each named by the innermost of the
benchmark's own spans (``bench::<layer>``) open at its middle.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPAN_PREFIX = "bench::"
WINDOW_SPAN = SPAN_PREFIX + "window"


@dataclass
class Trace:
    """Device intervals [(start_ns, end_ns, name)] and the benchmark's
    spans [(start_ns, end_ns, name)], on one clock."""
    device: List[Tuple[int, int, str]]
    spans: List[Tuple[int, int, str]]
    window: Tuple[int, int]
    by_name: Dict[str, Tuple[int, float]] = field(default_factory=dict)

    def __post_init__(self):
        acc: Dict[str, list] = defaultdict(lambda: [0, 0.0])
        for s, e, name in self.device:
            acc[name][0] += 1
            acc[name][1] += (e - s) * 1e-9
        self.by_name = {k: (v[0], v[1]) for k, v in acc.items()}

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def kernel(self, fragment: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds
        ``fragment``."""
        n, t = 0, 0.0
        for name, (c, s) in self.by_name.items():
            if fragment in name:
                n, t = n + c, t + s
        return n, t

    def busy_s(self) -> float:
        return sum(e - s for s, e in union(self.device, self.window)) * 1e-9

    def top_device_ops(self, n: int = 10) -> List[list]:
        rows = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name[:160], s] for name, (_c, s) in rows]

    def idle_by_span(self, n: int = 10) -> List[list]:
        """Idle seconds inside the window summed by the innermost span
        open at each gap's middle, the ``n`` largest."""
        acc = defaultdict(float)
        for name, length in name_gaps(gaps(union(self.device, self.window),
                                           self.window), self.spans):
            acc[name] += length * 1e-9
        return [[k, v] for k, v in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:n]]


def union(intervals, window) -> List[Tuple[int, int]]:
    """The union of ``intervals`` [(start, end, ...)] clipped to
    ``window``, as sorted disjoint (start, end) pairs."""
    lo, hi = window
    out: List[List[int]] = []
    for iv in sorted((max(iv[0], lo), min(iv[1], hi)) for iv in intervals):
        s, e = iv
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(merged, window) -> List[Tuple[int, int]]:
    """The holes of the disjoint sorted ``merged`` inside ``window``."""
    out, t = [], window[0]
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if window[1] > t:
        out.append((t, window[1]))
    return out


def name_gaps(holes, spans) -> List[Tuple[str, int]]:
    """(name of the innermost span open at the middle, length) of each
    hole; spans nest (one host thread), so a stack sweep finds it."""
    events = []
    for i, (s, e, name) in enumerate(spans):
        events.append((s, 0, i))
        events.append((e, 2, i))
    for j, (s, e) in enumerate(holes):
        events.append(((s + e) // 2, 1, j))
    events.sort()
    stack: List[int] = []
    out = []
    for _t, kind, i in events:
        if kind == 0:
            stack.append(i)
        elif kind == 2:
            if i in stack:
                stack.remove(i)
        else:
            s, e = holes[i]
            inner = [k for k in stack if spans[k][2] != WINDOW_SPAN]
            name = spans[inner[-1]][2][len(SPAN_PREFIX):] if inner \
                else "host outside the solver"
            out.append((name, e - s))
    return out


def collect(prof) -> Trace:
    """The device intervals and the benchmark's spans of a finished
    ``torch.profiler.profile``, read from its raw events (no per-event
    Python objects beyond one tuple each)."""
    from torch.autograd import DeviceType
    device, spans, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            # the profiler mirrors each record_function range onto the
            # device timeline; those ranges are not device work
            if not ev.name().startswith(SPAN_PREFIX):
                device.append((ev.start_ns(), ev.end_ns(), ev.name()))
        elif ev.name().startswith(SPAN_PREFIX):
            iv = (ev.start_ns(), ev.end_ns(), ev.name())
            spans.append(iv)
            if ev.name() == WINDOW_SPAN:
                window = iv[:2]
    if window is None:
        raise RuntimeError("the trace holds no window span")
    return Trace(device=device, spans=spans, window=window)
