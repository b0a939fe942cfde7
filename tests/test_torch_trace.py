"""The port's tracer (``utils/timer.py``): spans and counters recorded
inside the diag, Lanczos, large-sector and GF layers of each solve.

Two solves on the CPU: the plaquette + 1 replica bath (Ns=8, mixed
precision, ``lanc_dim_threshold=16``), whose sweep takes the dense, the
serial and the batched paths and re-solves sectors in f64, and the
2-site real case (Ns=4) with ``split.DENSE_FACTOR_MAX`` lowered so that
its (2,2) sector takes the large kits with their bf16 coarse stage.
Each runs twice untraced at one bath and once under a CPU
``torch.profiler`` session, with ``record_function`` patched to raise:
the program must never enter it.
"""
import numpy as np
import pytest
import threadpoolctl
import torch
from torch.profiler import ProfilerActivity, profile

import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_torch.ops import lanczos
from cdmft_lanc_ed_torch.ops import split as tsplit
from cdmft_lanc_ed_torch.utils import timer

STAGES = {"diagonalization", "greens_functions", "observables"}

INNER = {
    "plaquette": {"sector.build", "diag.batch", "diag.batch.stack",
                  "diag.serial", "diag.dense", "diag.retain",
                  "lanczos.expand", "lanczos.restart", "lanczos.refine",
                  "lanczos.f64_resolve", "lanczos.host_eigh", "gf.chains",
                  "gf.sigma"},
    "large": {"sector.build", "diag.large", "diag.large.start",
              "diag.retain", "large.build",
              "lanczos.expand", "lanczos.restart", "lanczos.refine",
              "lanczos.host_eigh", "gf.chains", "gf.sigma"},
}
COUNTERS = {
    "plaquette": {"host_reads", "lanczos.restarts", "lanczos.matvecs.f32",
                  "lanczos.matvecs.f64", "lanczos.f64_resolves",
                  "gf.steps"},
    "large": {"host_reads", "lanczos.restarts", "lanczos.matvecs.bf16",
              "lanczos.matvecs.f32", "lanczos.matvecs.f64", "gf.steps"},
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One BLAS and one intra-op thread: the suite runs in several worker
    processes at once."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(nthreads)


def _plaquette(tmp):
    cfg = tpkg.EDConfig(nlat=4, norb=1, nspin=1, nbath=1, uloc=[4.0],
                        beta=8.0, lmats=32, lreal=16, lanc_ngfiter=32,
                        ed_verbose=0, ed_twin=True, lanc_nstates_sector=1,
                        lanc_dim_threshold=16, ed_precision="mixed",
                        work_dir=str(tmp))
    hloc = np.zeros((4, 4, 1, 1, 1, 1), np.complex128)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        hloc[i, j, 0, 0, 0, 0] = hloc[j, i, 0, 0, 0, 0] = -1.0
    basis = np.zeros((1, 4, 4, 1, 1, 1, 1), np.complex128)
    for il in range(4):
        basis[0, il, il, 0, 0, 0, 0] = 1.0
    return cfg, hloc, basis, np.array([[-0.5]])


def _large(tmp):
    (tmp / "sectors_list.restart").write_text(" 2 2\n")
    cfg = tpkg.EDConfig(nlat=2, norb=1, nspin=1, nbath=1, uloc=[2.0],
                        beta=50.0, lmats=32, lreal=16, lanc_dim_threshold=4,
                        ed_verbose=0, ed_sectors=True, ed_sectors_shift=0,
                        ed_precision="mixed", work_dir=str(tmp))
    nn = (2, 2, 1, 1, 1, 1)
    hloc = np.zeros(nn, np.complex128)
    hloc[0, 1, 0, 0, 0, 0] = hloc[1, 0, 0, 0, 0, 0] = -1.0
    basis = np.zeros((1,) + nn, np.complex128)
    for il in range(2):
        basis[0, il, il, 0, 0, 0, 0] = 1.0
    return cfg, hloc, basis, np.array([[0.3]])


def _forbidden(*a, **kw):
    raise AssertionError("the program entered record_function")


@pytest.fixture(scope="module", params=["plaquette", "large"])
def runs(request, tmp_path_factory):
    """Two untraced solves at one bath and a traced one, each a dict of
    the solve's timers and its change of ``lanczos.f64_fallbacks``; the
    traced one also has the profiler's range around it and the solve's
    entry of ``traced_solves()``."""
    case = request.param
    mp = pytest.MonkeyPatch()
    outer_range = torch.profiler.record_function
    mp.setattr(torch.autograd.profiler, "record_function", _forbidden)
    mp.setattr(torch.profiler, "record_function", _forbidden)
    if case == "large":
        mp.setattr(tsplit, "DENSE_FACTOR_MAX", 5)
    try:
        cfg, hloc, basis, lam = (_plaquette if case == "plaquette"
                                 else _large)(tmp_path_factory.mktemp(case))
        solver = tpkg.EDSolver(cfg, device="cpu")
        solver.set_hbath(basis, lam)
        bath = solver.init_solver()
        out = []

        def solve():
            f0 = lanczos.f64_fallbacks
            solver.solve(bath, hloc)
            out.append({"timers": solver.timers,
                        "fallbacks": lanczos.f64_fallbacks - f0})

        n_traced = len(timer.traced_solves())
        solve()
        solve()
        assert len(timer.traced_solves()) == n_traced
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with outer_range("warm-up"):
                pass
            with outer_range("test.solve"):
                solve()
        out[-1]["solve"] = timer.traced_solves()[-1]
        out[-1]["range"] = [(ev.start_ns(), ev.end_ns()) for ev in
                            prof.profiler.kineto_results.events()
                            if ev.name() == "test.solve"][0]
    finally:
        mp.undo()
    return case, out


def test_totals_hold_stage_and_inner_spans(runs):
    case, out = runs
    for r in out:
        t = r["timers"]
        assert set(t.totals) >= STAGES | INNER[case]
        assert set(t.counts) == set(t.totals)
        assert set(t.counters) >= COUNTERS[case]
        assert t.counts["diagonalization"] == 1


def test_stage_covers_its_children(runs):
    _, out = runs
    spans = out[-1]["solve"]["spans"]
    stages = [i for i, s in enumerate(spans) if s[2] in STAGES]
    assert {spans[i][2] for i in stages} == STAGES
    for i in stages:
        assert spans[i][3] == -1
        children = sum(e - s for s, e, _, p, _ in spans if p == i)
        assert spans[i][1] - spans[i][0] >= children
        assert out[-1]["timers"].totals[spans[i][2]] >= children * 1e-9
    # every span inside its parent's interval
    for s, e, _, p, _ in spans:
        assert s <= e
        if p >= 0:
            assert spans[p][0] <= s and e <= spans[p][1]


def test_counters_repeat_without_carry_over(runs):
    _, out = runs
    first, second, traced = (r["timers"] for r in out)
    assert first.counters == second.counters == traced.counters
    assert first.counts == second.counts == traced.counts
    assert out[-1]["solve"]["counters"] == traced.counters


def test_f64_resolves_match_the_module_counter(runs):
    case, out = runs
    for r in out:
        assert r["timers"].counters.get("lanczos.f64_resolves", 0) == \
            r["fallbacks"]
    if case == "plaquette":
        assert out[0]["fallbacks"] > 0


def test_span_list_only_under_a_profiler(runs):
    _, out = runs
    assert out[0]["timers"].spans == [] and out[1]["timers"].spans == []
    traced = out[-1]["timers"]
    assert len(traced.spans) == sum(traced.counts.values())
    assert out[-1]["solve"]["spans"] == [tuple(s) for s in traced.spans]


def test_traced_spans_nest_with_sector_attributes(runs):
    case, out = runs
    spans = out[-1]["solve"]["spans"]
    names = [s[2] for s in spans]

    def ancestors(i):
        while spans[i][3] >= 0:
            i = spans[i][3]
            yield spans[i][2]

    for i, (_, _, name, _, attrs) in enumerate(spans):
        if name == "sector.build":
            assert len(attrs["sector"]) == 2
            assert {"diagonalization", "greens_functions"} & \
                set(ancestors(i))
        if name in ("diag.serial", "diag.large", "diag.dense"):
            assert set(attrs) == {"sector", "dim"}
        if name == "gf.chains":
            assert spans[spans[i][3]][2] == "greens_functions"
            assert set(attrs) == {"sector", "rows", "large"}
        if name == "lanczos.expand":
            assert attrs["steps"] > 0 and attrs["batch"] >= 1
    if case == "plaquette":
        batch = [s for s in spans if s[2] == "diag.batch"]
        assert all(len(s[4]["sectors"]) >= 2 and s[4]["kind"] == "real"
                   for s in batch)
        resolves = [i for i, n in enumerate(names)
                    if n == "lanczos.f64_resolve"]
        # a batch member's re-solve names its sector; a serial one lies
        # in its sector's span
        assert resolves
        for i in resolves:
            up = set(ancestors(i))
            assert ("sector" in spans[i][4] and "diag.batch" in up) or \
                "diag.serial" in up
        expand = [i for i, n in enumerate(names) if n == "lanczos.expand"]
        assert any("diag.batch" in set(ancestors(i)) for i in expand)
    else:
        large = [s for s in spans if s[2] == "large.build"]
        assert {s[4]["dtype"] for s in large} >= {"torch.float32",
                                                  "torch.bfloat16",
                                                  "torch.float64"}
        assert any(s[4]["dtype"] == "bf16" for s in spans
                   if s[2] == "lanczos.expand")


def test_solve_shares_the_profiler_clock(runs):
    """The solve's logged start and end lie within 1 ms inside the
    profiler's own range around ``solver.solve``."""
    _, out = runs
    start, end = out[-1]["range"]
    solve = out[-1]["solve"]
    assert start <= solve["start_ns"] <= start + 1_000_000
    assert end - 1_000_000 <= solve["end_ns"] <= end
    assert all(start <= s[0] and s[1] <= end for s in solve["spans"])
