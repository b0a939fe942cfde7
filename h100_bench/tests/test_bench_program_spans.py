"""Device idle under the program's own spans, on synthetic device
intervals and traced solves: nested spans count once, spans and holes
are clipped at the window, and a record that does not cover the window's
solves reads nothing."""
from types import SimpleNamespace

import pytest

import bench_helpers  # noqa: F401  (paths)
import devtrace
import program_spans
from cdmft_lanc_ed_torch.utils import timer


def make_run(device, solves, window=(0, 100), nsolves=None):
    spans = [(window[0], window[1], devtrace.WINDOW_SPAN)]
    trace = devtrace.Trace(device=device, spans=spans, window=window)
    n = len(solves) if nsolves is None else nsolves
    return SimpleNamespace(
        trace=trace, kernels={}, counters={"launches": {}},
        solves=[{"stages": s.get("totals", {})} for s in solves][:n]
        + [{"stages": {}}] * max(0, n - len(solves)))


def solve(start, end, spans, counters=None, totals=None):
    return {"start_ns": start, "end_ns": end, "spans": spans,
            "counters": counters or {}, "totals": totals or {}}


@pytest.fixture
def traced(monkeypatch):
    kept = []
    monkeypatch.setattr(timer, "traced_solves", lambda: list(kept))
    return kept


def test_nested_spans_count_once(traced):
    # device busy [10, 20] and [50, 60]: holes [0,10], [20,50], [60,100]
    device = [(10, 20, "k"), (50, 60, "k")]
    spans = [(5, 90, "diagonalization", -1, {}),
             (15, 40, "lanczos.restart", 0, {}),
             # a restart inside another one's interval (a re-solve's own)
             (25, 35, "lanczos.restart", 1, {}),
             (55, 70, "lanczos.restart", 0, {})]
    traced.append(solve(1, 95, spans))
    run = make_run(device, traced)
    # under restart: [20, 40] of hole [20, 50] and [60, 70]: 30 ns
    assert program_spans.idle_per_solve(run, "lanczos.restart") == \
        pytest.approx(30e-9)
    # under the stage: [5,10] + [20,50] + [60,90] = 65 ns
    assert program_spans.idle_per_solve(run, "diagonalization") == \
        pytest.approx(65e-9)
    assert program_spans.idle_per_solve(run, "gf.chains") == 0.0


def test_clipped_at_the_window_and_divided_by_all_solves(traced):
    device = [(30, 40, "k")]
    window = (20, 80)
    # a span that starts before the window and one that ends after it;
    # the second solve holds no expand span
    traced.append(solve(20, 50, [(0, 35, "lanczos.expand", -1, {})],
                        counters={"host_reads": 7},
                        totals={"lanczos.f64_resolve": 0.5}))
    traced.append(solve(50, 80, [(70, 120, "lanczos.expand", -1, {})],
                        counters={"host_reads": 3}))
    run = make_run(device, traced, window=window)
    # holes [20, 30] and [40, 80]; under expand: [20, 30] + [70, 80]
    assert program_spans.idle_per_solve(run, "lanczos.expand") == \
        pytest.approx(10e-9)
    assert program_spans.counter_per_solve(run, "host_reads") == 5.0
    assert program_spans.span_s_per_solve(run, "lanczos.f64_resolve") == \
        0.25


def test_nothing_when_the_record_misses_a_solve(traced):
    device = [(10, 20, "k")]
    traced.append(solve(0, 50, [(0, 50, "lanczos.expand", -1, {})],
                        counters={"host_reads": 1}))
    # a solve outside the window does not count for it
    traced.append(solve(150, 160, [], counters={"host_reads": 1}))
    run = make_run(device, traced[:1], nsolves=2)
    for read in (program_spans.idle_per_solve,
                 program_spans.counter_per_solve,
                 program_spans.span_s_per_solve):
        assert read(run, "lanczos.expand") is None
    # an untraced run, and a program that keeps no traced solves
    run = make_run(device, traced[:1])
    assert program_spans.counter_per_solve(run, "host_reads") == 1.0
    run.trace = None
    assert program_spans.counter_per_solve(run, "host_reads") is None


def test_nothing_from_a_program_without_the_record(monkeypatch):
    monkeypatch.delattr(timer, "traced_solves")
    run = make_run([(10, 20, "k")], [solve(0, 50, [])])
    assert program_spans.idle_per_solve(run, "lanczos.restart") is None


def test_the_metric_files_read_their_spans(traced):
    """Each new reader file reads its span or counter through the shared
    helpers."""
    import harness
    device = [(10, 20, "k")]
    spans = [(0, 100, "diagonalization", -1, {}),
             (20, 30, "lanczos.expand", 0, {}),
             (30, 40, "lanczos.restart", 0, {}),
             (40, 60, "lanczos.host_eigh", 0, {})]
    traced.append(solve(0, 100, spans,
                        counters={"host_reads": 4,
                                  "lanczos.matvecs.f64": 9},
                        totals={"lanczos.f64_resolve": 1.5,
                                "large.build": 2.5}))
    run = make_run(device, traced)
    want = {"restart_idle_s.ns12": 10e-9, "expand_idle_s.ns12": 10e-9,
            "host_eigh_idle_s.ns12": 20e-9, "f64_resolve_s.ns12": 1.5,
            "host_reads.ns12": 4.0, "factor_build_s.ns16": 2.5,
            "f64_matvecs.ns16": 9.0}
    for name, value in want.items():
        got = harness.load_reader(bench_helpers.BENCH, name)(run)
        assert got == pytest.approx(value), name
