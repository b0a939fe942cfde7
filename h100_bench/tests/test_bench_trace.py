"""Busy time as the union of device intervals, and idle gaps named by
the innermost span."""
import pytest

import bench_helpers  # noqa: F401  (paths)
import devtrace


def make(device, spans, window=(0, 100)):
    spans = [(window[0], window[1], devtrace.WINDOW_SPAN)] + spans
    return devtrace.Trace(device=device, spans=spans, window=window)


def test_overlapping_streams_count_once():
    # two streams overlap on [20, 30]; a kernel pokes out of the window
    t = make([(10, 30, "a"), (20, 40, "b"), (60, 70, "a"), (95, 130, "c")],
             [])
    assert devtrace.union(t.device, t.window) == [(10, 40), (60, 70),
                                                 (95, 100)]
    assert t.busy_s() == pytest.approx(45e-9)
    # the sum of durations would say 20 + 20 + 10 + 35 = 85 ns
    assert sum(e - s for s, e, _ in t.device) == 85
    assert t.kernel("a") == (2, pytest.approx(30e-9))


def test_idle_gaps_take_the_innermost_span():
    device = [(10, 20, "k"), (50, 60, "k")]
    spans = [(0, 100, "bench::solve"), (20, 45, "bench::diag"),
             (25, 35, "bench::diag.sector_build")]
    t = make(device, spans)
    # holes [0,10] (solve), [20,50] (middle 35: diag ends at 45, the
    # sector build at 35), [60,100] (solve)
    got = dict((k, v) for k, v in t.idle_by_span())
    assert got["solve"] == pytest.approx(50e-9)
    assert got["diag.sector_build"] + got.get("diag", 0.0) == \
        pytest.approx(30e-9)
    assert 1.0 - t.busy_s() / t.window_s == pytest.approx(0.8)
