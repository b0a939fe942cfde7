"""The harness at a CPU size: new cells, mixes and metrics are files found
by name; a sound run is correct; the lower-precision control and the
faults a solve can have are not."""
import json
import time

import numpy as np
import pytest
import torch

import bench_helpers
import harness


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(d, bench, cell, seconds=0.5, trace=False, seed=2 ** 33 + 1):
    return harness.run_cell(d, bench, cell, seed, seconds, trace, "cpu",
                            time.perf_counter())


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    d, bench, _ = bench_helpers.tiny_bench(tmp_path)
    # a throw-away mix and per-layer metric, added as files and entries
    mix = json.loads((d / "traffic" / "full_sweep.json").read_text())
    mix["amplitude"] = 0.05
    (d / "traffic" / "calm.json").write_text(json.dumps(mix))
    (d / "metrics" / "sectors_kept.tiny.py").write_text(
        "def read(run):\n"
        "    return float(sum(len(s['sectors']) for s in run.solves))\n")
    bench["workloads"].append({"name": "tiny.calm", "config": "tiny",
                               "traffic": "calm", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "sectors_kept.tiny", "unit": "count",
                               "better": "lower", "source": "program_span",
                               "layer": "solver / diag", "moves": "solve_s",
                               "workloads": ["tiny.calm"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny.full_sweep" in m["workloads"]:
            m["workloads"].append("tiny.calm")
    out = run(d, bench, "tiny.calm", trace=True)
    assert out["correct"] is True
    assert out["metrics"]["sectors_kept.tiny"]["value"] >= 1.0
    assert {"diag_s.ns12", "gf_s.ns12", "f64_resolves.ns12"} <= \
        set(out["metrics"])
    assert list(out)[-1] == "checks"
    plain = run(d, bench, "tiny.calm")
    assert set(plain["metrics"]) == {"setup_s", "solve_s"}
    assert plain["attempted"] >= 1 and plain["failed"] == 0


def test_a_new_model_family_is_added_as_files_only(tmp_path):
    """A BHZ chain with a general bath (complex, two orbitals, two spins;
    Ns=8) comes in as new files alone: its model's two sides, its
    configuration, the complex H·v kernel it names and two metrics."""
    d = bench_helpers.copy_bench(tmp_path)
    fixture = bench_helpers.BENCH / "tests" / "fixtures" / "bhz_general"
    for src in fixture.rglob("*.py"):
        dst = d / src.relative_to(fixture)
        assert not dst.exists()
        dst.write_bytes(src.read_bytes())
    for src in fixture.rglob("*.json"):
        dst = d / src.relative_to(fixture)
        assert not dst.exists()
        dst.write_bytes(src.read_bytes())
    bench = json.loads((bench_helpers.ROOT / "BENCHMARK.json").read_text())
    cell = "bhz1d_ns8.near_sweep"
    bench["workloads"].append({"name": cell, "config": "bhz1d_ns8",
                               "traffic": "near_sweep", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "solve_s":
            m["workloads"].append(cell)
    for name, kernel in (("gf_s.bhz8", "gf"),
                         ("pair_kernel_roofline.bhz8", "ops/fused")):
        bench["per_layer"].append({
            "name": name, "unit": "s" if kernel == "gf" else "%",
            "better": "lower" if kernel == "gf" else "higher",
            "source": "program_span", "layer": kernel, "moves": "solve_s",
            "workloads": [cell]})
    traced = run(d, bench, cell, seconds=0.2, trace=True)
    assert traced["correct"] is True, traced["checks"]
    # off the card no launch is counted: the roofline is left out
    assert set(traced["metrics"]) == {"gf_s.bhz8"}
    plain = run(d, bench, cell, seconds=0.2)
    assert plain["correct"] is True and plain["failed"] == 0
    assert set(plain["metrics"]) == {"setup_s", "solve_s"}


def test_the_bhz_reference_is_complex_and_agrees_on_both_spins(tmp_path):
    import importlib.util
    fixture = bench_helpers.BENCH / "tests" / "fixtures" / "bhz_general"
    spec = importlib.util.spec_from_file_location(
        "bhz_reference", fixture / "reference" / "bhz_general.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = json.loads((fixture / "configs" / "bhz1d_ns8.json").read_text())
    p = mod.problem(cfg, cfg["bath"])
    assert p.is_complex and not p.spin_symmetric
    from reference.cluster_ed import solve
    sol = solve(p, harness.reference_sectors(cfg, p.ns))
    # time reversal: G↓ = G↑ transposed, and G is not symmetric
    assert np.abs(sol.g[1] - sol.g[0].transpose(1, 0, 2)).max() < 1e-9
    assert np.abs(sol.g[0] - sol.g[0].transpose(1, 0, 2)).max() > 1e-3


def test_the_float32_reference_in_the_programs_place_fails(tmp_path):
    from control import solution_record
    import traffic
    d, bench, cell_name = bench_helpers.tiny_bench(tmp_path)
    cell = harness.load_cell(d, bench, cell_name)
    limits = cell.config["limits"]
    for seed in (1, 2, 3):
        bath = next(traffic.baths(cell.model, cell.config, 0.1, seed))
        ref = harness.reference_solve(cell, bath, seed, "cpu")
        ctl = harness.reference_solve(cell, bath, seed, "cpu", torch.float32)
        g = harness.gaps(solution_record(ctl), ref)
        assert any(g[k] > limits[k] for k in limits), g


def _broken_run(tmp_path, monkeypatch, breaker):
    from cdmft_lanc_ed_torch import solver as solver_mod
    d, bench, cell = bench_helpers.tiny_bench(tmp_path)
    breaker(monkeypatch, solver_mod.EDSolver)
    return run(d, bench, cell, seconds=1.5)


def test_a_solve_that_leaves_its_state_unchanged_fails(tmp_path,
                                                      monkeypatch):
    def breaker(mp, cls):
        real = cls.solve

        def stale(self, bath, hloc):
            # solved once (at the unperturbed bath), then never again
            if self.gf is None:
                b = np.array(bath, float)
                b[len(b) // 2:] = [0.5, 0.0]
                real(self, b, hloc)
        mp.setattr(cls, "solve", stale)
    out = _broken_run(tmp_path, monkeypatch, breaker)
    assert out["correct"] is False


def test_an_answer_altered_where_it_is_produced_fails(tmp_path,
                                                      monkeypatch):
    def breaker(mp, cls):
        real = cls.gimp_matsubara

        def altered(self):
            g = np.array(real(self))
            g[0, 0] *= 1.0 + 1e-4
            return g
        mp.setattr(cls, "gimp_matsubara", altered)
    out = _broken_run(tmp_path, monkeypatch, breaker)
    assert out["correct"] is False
    assert out["checks"]["g_gap"]["value"] > out["checks"]["g_gap"]["limit"]
