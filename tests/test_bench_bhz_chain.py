"""The benchmark's BHZ chain configuration (``h100_bench/configs/
bhz1d_ns12.json``) at a CPU size: the configuration cut to Ns=8 (one
general bath), solved by the port and by the plain reference
(``h100_bench/reference/bhz_chain.py``) at seeded baths of the cell's
traffic and compared under the configuration's own limits; the
reference's time reversal; the GF's injection counters; and the whole
configuration found by the harness, file by file.

The port's sweep is cut to the half-filled sector (``ed_sectors``, shift
0; the reference still searches the 3x3 sectors around it): on one CPU
thread a solve's full sweep takes 20 s and the 3x3 sweep 9 s, most of it
the complex128 GF chains that every cut keeps.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import threadpoolctl
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "h100_bench"
for _p in (str(BENCH), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402
import traffic  # noqa: E402

CELL = "bhz1d_ns12.full_sweep"
# the cut to Ns=8 (the first of the two baths), as the harness tests cut
# the plaquette
NS8 = {"nbath": 1, "lmats": 64, "lanc_ngfiter": 60}
SEEDS = (11, 2 ** 31 + 5, 3120013003)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One BLAS and one intra-op thread: the suite runs in several worker
    processes at once."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(nthreads)


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _cut(cell_name: str, ed: dict, bath) -> harness.Cell:
    """The cell with its configuration cut: ``ed`` over the configuration's
    EDConfig keywords, ``bath(published)`` as the published bath, and the
    sweep cut to the half-filled sector."""
    cell = harness.load_cell(BENCH, _bench(), cell_name)
    cfg = json.loads(json.dumps(cell.config))
    cfg["ed"].update(ed, ed_verbose=0)
    cfg["bath"] = bath(cfg["bath"])
    sweep = {"ed_sectors": True, "ed_sectors_shift": 0,
             "restart": "half_filling"}
    return dataclasses.replace(cell, config=cfg,
                               traffic={**cell.traffic, "sweep": sweep})


def _bhz8() -> harness.Cell:
    return _cut(CELL, NS8, lambda b: {k: v[:1] for k, v in b.items()})


def _program_solve(cell: harness.Cell, bath: dict, work_dir: Path):
    solver = harness.make_solver(cell, str(work_dir), torch.device("cpu"))
    solver.solve(cell.model.bath_array(cell.config, bath),
                 cell.model.hloc(cell.config, cell.reference))
    return solver


def _first_bath(cell: harness.Cell, seed: int) -> dict:
    return next(traffic.baths(cell.model, cell.config,
                              cell.traffic["amplitude"], seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_ns8_port_against_the_reference(tmp_path, seed):
    """The port's solve within the configuration's limits of the plain
    reference, at the seed's first bath; its GF builds 112 injection rows
    at one retained state, 48 of them (a ± i b) rows."""
    cell = _bhz8()
    assert cell.config["ed"]["nbath"] == 1
    bath = _first_bath(cell, seed)
    solver = _program_solve(cell, bath, tmp_path)
    rec = harness._record(solver, bath, 0.0)
    sol = harness.reference_solve(cell, bath, seed, "cpu")
    assert rec["sectors"] == sol.sectors == [(4, 4)]
    limits = cell.config["limits"]
    g = harness.gaps(rec, sol)
    assert all(g[k] <= limits[k] for k in limits), (g, limits)
    counters = solver.timers.counters
    assert counters["gf.injections"] == 112
    assert counters["gf.injections.chan4"] == 48
    assert solver.timers.counts["gf.inject"] == 4


def test_ns8_reference_time_reversal():
    """G↓ = G↑ transposed (time reversal maps H↑ to its conjugate), and G
    is not symmetric: the (a ± i b) channels carry information."""
    from reference.cluster_ed import solve
    cell = _bhz8()
    bath = _first_bath(cell, SEEDS[0])
    p = cell.reference.problem(cell.config, bath)
    assert p.ns == 8 and p.is_complex and not p.spin_symmetric
    sol = solve(p, harness.reference_sectors(cell.config, p.ns))
    assert np.abs(sol.g[1] - sol.g[0].transpose(1, 0, 2)).max() < 1e-9
    assert np.abs(sol.g[0] - sol.g[0].transpose(1, 0, 2)).max() > 1e-3


def test_ns8_plaquette_counts_no_chan4_rows(tmp_path):
    """The real plaquette (one replica bath, Ns=8) takes the 2-channel
    scheme: 32 injection rows, none of them (a ± i b)."""
    cell = _cut("plaquette_ns12.full_sweep", NS8,
                lambda b: {"levels": [0.0], "v": [0.5]})
    solver = _program_solve(cell, _first_bath(cell, SEEDS[1]), tmp_path)
    assert solver.timers.counters["gf.injections"] == 32
    assert solver.timers.counters["gf.injections.chan4"] == 0


def test_the_ns12_configuration_loads_with_every_file():
    """``bhz1d_ns12.json`` as committed: the harness loads its cell, and
    every file that the cell, its configuration and its metrics name is
    there."""
    bench = _bench()
    cell = harness.load_cell(BENCH, bench, CELL)
    cfg = cell.config
    assert cell.spec["chips"] == 1 and cell.spec["traffic"] == "full_sweep"
    assert cfg["reduced"] == [] and cfg["model"] == "bhz_chain"
    assert set(cell.kernels) == {"pair_matvec"}
    assert cell.kernels["pair_matvec"].ENTRY == (
        "cdmft_lanc_ed_torch.ops.fused", "fused_pair_matvec")
    for fn in ("draw_bath", "hloc", "bath_array", "make_solver"):
        assert callable(getattr(cell.model, fn))
    assert callable(cell.reference.problem)
    entry = next(c for c in bench["configs"] if c["name"] == "bhz1d_ns12")
    assert (ROOT / entry["file"]).is_file() and entry["reduced"] == []
    names = [m["name"] for m in harness.metrics_of(bench, "end_to_end", CELL)
             + harness.metrics_of(bench, "per_layer", CELL)]
    assert {"setup_s", "solve_s", "gf_s.bhz12", "gf_inject_idle_s.bhz12",
            "gf_injections.bhz12", "pair_kernel_roofline.bhz12",
            "c128_resolves.bhz12", "device_idle.bhz12"} == set(names)
    for name in names:
        assert callable(harness.load_reader(BENCH, name))
    # the published problem: Ns=12, complex, both spins, 2 general baths
    p = cell.reference.problem(cfg, cfg["bath"])
    assert p.ns == 12 and p.nimp == 4 and p.is_complex
    assert cfg["ed"]["nbath"] == 2 and cfg["ed"]["bath_type"] == "general"
    assert len(cell.model.bath_array(cfg, cfg["bath"])) == 2 + 2 * (8 + 3)
