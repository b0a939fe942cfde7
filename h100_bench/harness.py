"""One run of one cell of ``BENCHMARK.json``.

The cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``).  The configuration names its model
(``models/<model>.py``: the bath of each solve and the program's solver
for it; ``reference/<model>.py``: the plain problem of the same solve)
and the program's kernels it runs (``kernels/<name>.py``: each one's trace
row, counter, bound and warm-up).  Every metric is a reader
``metrics/<name>.py`` with ``read(run) -> float | None``.  Nothing here
lists cells, configurations, models, kernels or metrics: a new one is a
new file and a new entry.

A run: set-up (kernel build or cache load, the solver, the cell's
shapes warmed up), then a closed loop of ``EDSolver.solve`` calls at baths
drawn from the seed for ``--seconds`` (no solve starts after that), then
the checks of a sample of the window's solves against the plain reference
(``reference/cluster_ed.py``), then one JSON line.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from math import comb
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

import traffic as traffic_gen

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cdmft_lanc_ed_tpu")
PROGRAM = "cdmft_lanc_ed_torch"


def forbidden_modules(names=None) -> List[str]:
    """Top-level names (the part before the first dot, whole) of loaded
    modules that the port's runs must not load."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, section: str, cell: str) -> List[dict]:
    """The metrics of ``section`` that cell ``cell`` reports."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def load_module(bench_dir: Path, folder: str, name: str):
    """``<bench_dir>/<folder>/<name>.py``, loaded from its path."""
    path = bench_dir / folder / f"{name}.py"
    key = "bench_%s_%s_%s" % (folder, name.replace(".", "_").replace(
        "-", "_"), abs(hash(str(path))))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reader(bench_dir: Path, name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return load_module(bench_dir, "metrics", name).read


# ---------------------------------------------------------------------------
# the cell: its configuration, mix, model and kernels
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    spec: dict
    config: dict
    traffic: dict
    model: object              # models/<model>.py
    reference: object          # reference/<model>.py
    kernels: Dict[str, object]  # name -> kernels/<name>.py

    @property
    def settings(self) -> dict:
        """EDConfig keywords: the configuration's, then the mix's sweep."""
        sweep = {k: v for k, v in self.traffic.get("sweep", {}).items()
                 if k != "restart"}
        return {**self.config["ed"], **sweep}


def load_cell(bench_dir: Path, bench: dict, name: str) -> Cell:
    spec = cell_of(bench, name)
    config = load_json(bench_dir / "configs" / f"{spec['config']}.json")
    return Cell(
        spec=spec, config=config,
        traffic=load_json(bench_dir / "traffic" / f"{spec['traffic']}.json"),
        model=load_module(bench_dir, "models", config["model"]),
        reference=load_module(bench_dir, "reference", config["model"]),
        kernels={k: load_module(bench_dir, "kernels", k)
                 for k in config["kernels"]})


def half_filling(ns: int):
    return ns // 2, ns // 2


def swept_sectors(ns: int, settings: dict) -> List[tuple]:
    """The sectors of the first solve's sweep."""
    if not settings.get("ed_sectors"):
        return [(a, b) for a in range(ns + 1) for b in range(ns + 1)]
    s = settings.get("ed_sectors_shift", 1)
    h, _ = half_filling(ns)
    return [(a, b) for a in range(h - s, h + s + 1)
            for b in range(h - s, h + s + 1)]


def make_solver(cell: Cell, work_dir: str, device, **overrides):
    """The program's solver for the cell, its restart file written."""
    solver = cell.model.make_solver(cell.config,
                                    {**cell.settings, **overrides},
                                    work_dir, device, cell.reference)
    if cell.traffic.get("sweep", {}).get("restart") == "half_filling":
        with open(os.path.join(work_dir, "sectors_list.restart"), "w") as fh:
            fh.write(" %d %d\n" % half_filling(solver.cfg.ns))
    return solver


def warm_up(cell: Cell, ns: int, device) -> None:
    """Launch each kernel of the configuration once at each shape that the
    cell's sectors use (``kernels/<name>.py`` warm), and touch the library
    calls of a solve (eigh, complex inversion), so that no library loads
    inside the window.  Not a solve."""
    import torch
    dims = [(comb(ns, a), comb(ns, b))
            for a, b in swept_sectors(ns, cell.settings)]
    for name, kmod in cell.kernels.items():
        kmod.warm(dims, cell.config["kernels"][name], device)
    m = torch.eye(8, device=device, dtype=torch.float64)
    torch.linalg.eigh(m)
    torch.linalg.inv(m.to(torch.complex128))
    if device.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

@dataclass
class Run:
    """What the metric readers read.  The cell, configuration and mix are
    here for readers that later cells add: they bring new reader files and
    cannot edit this one."""
    cell: dict
    config: dict
    traffic: dict
    seconds: float
    traced: bool
    kernels: Dict[str, object] = field(default_factory=dict)
    setup_s: float = 0.0
    setup_stages: Dict[str, float] = field(default_factory=dict)
    compiled: bool = False
    window_s: float = 0.0
    solves: List[dict] = field(default_factory=list)
    counters: Dict[str, object] = field(default_factory=dict)
    launches: list = field(default_factory=list)
    trace: Optional[object] = None
    memory_peak_bytes: int = 0
    device_name: str = ""
    notes: List[str] = field(default_factory=list)


def _counters(kernels) -> dict:
    from cdmft_lanc_ed_torch.ops import lanczos
    return {"f64_fallbacks": int(lanczos.f64_fallbacks),
            "launches": {k: int(m.launches()) for k, m in kernels.items()}}


def _diff(after: dict, before: dict) -> dict:
    return {"f64_fallbacks": after["f64_fallbacks"] - before["f64_fallbacks"],
            "launches": {k: n - before["launches"][k]
                         for k, n in after["launches"].items()}}


def spin_blocks(a: np.ndarray) -> np.ndarray:
    """[Nlat, Nlat, Nspin, Nspin, Norb, Norb, L] -> [Nspin, nimp, nimp, L],
    impurity level ilat·Norb + iorb (the blocks diagonal in spin)."""
    nlat, _, nspin, _, norb = a.shape[:5]
    n = nlat * norb
    return np.stack([a[:, :, s, s].transpose(0, 2, 1, 3, 4).reshape(
        n, n, -1) for s in range(nspin)])


def _record(solver, bath, seconds: float) -> dict:
    """What one solve produced, kept for the checks (small arrays)."""
    ns = solver.cfg.ns
    return {
        "bath": bath, "seconds": seconds,
        "egs": float(solver.egs),
        "sectors": sorted(((st.isector - 1) // (ns + 1),
                           (st.isector - 1) % (ns + 1))
                          for st in solver.diag_state.state_list),
        "g": spin_blocks(np.asarray(solver.gimp_matsubara())),
        "sigma": spin_blocks(np.asarray(solver.sigma_matsubara())),
        "dens": np.array(solver.dens()).reshape(-1),
        "docc": np.array(solver.docc()).reshape(-1),
        "stages": dict(solver.timers.totals)}


def run_window(cell: Cell, solver, baths, hloc, seconds: float, sync,
               span=None):
    """Solves back to back until ``seconds`` have passed (one at least);
    returns (records, window seconds)."""
    from cdmft_lanc_ed_torch.ops import lanczos
    records = []
    t0 = time.perf_counter()
    while True:
        bath = next(baths)
        ts, f64 = time.perf_counter(), lanczos.f64_fallbacks
        with (span("solve") if span else contextlib.nullcontext()):
            solver.solve(cell.model.bath_array(cell.config, bath), hloc)
        sync()
        now = time.perf_counter()
        rec = _record(solver, bath, now - ts)
        rec["f64_resolves"] = lanczos.f64_fallbacks - f64
        records.append(rec)
        if now - t0 >= seconds:
            return records, now - t0


class Stages:
    """Seconds of each stage of set-up, on the host clock."""

    def __init__(self, t0: float):
        self.last, self.seconds = t0, {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.last
        self.last = now


def run_cell(bench_dir: Path, bench: dict, cell_name: str, seed: int,
             seconds: float, trace: bool, device: str, t_start: float,
             log=lambda s: None, stages: Optional[Stages] = None) -> dict:
    """One run; returns the result object (the last line's content)."""
    import torch
    stages = stages or Stages(t_start)
    cell = load_cell(bench_dir, bench, cell_name)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    run = Run(cell=cell.spec, config=cell.config, traffic=cell.traffic,
              seconds=seconds, traced=trace, kernels=cell.kernels,
              device_name=torch.cuda.get_device_name(dev) if on_card else "")
    if on_card:
        torch.empty(1, device=dev)
        stages("cuda_init")
        from cdmft_lanc_ed_torch import build
        run.compiled = not all(b["cached"] for b in build.build().values())
        stages("kernel_build" if run.compiled else "kernel_cache")
    work_dir = tempfile.mkdtemp(prefix="h100_bench_")
    try:
        solver = make_solver(cell, work_dir, dev)
        hloc = cell.model.hloc(cell.config, cell.reference)
        stages("solver")
        warm_up(cell, solver.cfg.ns, dev)
        stages("warm_up")
        baths = traffic_gen.baths(cell.model, cell.config,
                                  cell.traffic["amplitude"], seed,
                                  cell.traffic.get("pool"))
        before = _counters(cell.kernels)
        prof = instruments = None
        span = None
        if trace:
            import bounds
            import devtrace
            import instrument
            from torch.profiler import ProfilerActivity, profile
            instruments = instrument.Instruments(
                bounds.peaks_of(run.device_name), cell.kernels)
            instruments.install()

            def span(name):
                return torch.profiler.record_function(
                    devtrace.SPAN_PREFIX + name)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            prof.start()
        if on_card:
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
        stages("profiler" if trace else "window_start")
        run.setup_s = time.perf_counter() - t_start
        run.setup_stages = dict(stages.seconds)
        with (span("window") if trace else contextlib.nullcontext()):
            run.solves, run.window_s = run_window(cell, solver, baths, hloc,
                                                  seconds, sync, span)
        if trace:
            prof.stop()
            instruments.remove()
            run.trace = devtrace.collect(prof) if on_card else None
            run.launches = instruments.launches
            del prof
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev)) \
            if on_card else 0
        run.counters = _diff(_counters(cell.kernels), before)
        del solver
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, section, cell_name):
        value = load_reader(bench_dir, m["name"])(run)
        if value is None:
            if section == "end_to_end":
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   f"nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    for note in run.notes:
        log(note)
    log("set-up stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup_stages.items())
        + f"; compiled {run.compiled}")

    checks, failed = check_solves(run, cell, seed, dev, log)
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": len(run.solves), "failed": failed,
              "metrics": metrics,
              "device": device_record(dev, run)}
    # not read by the check: set-up by stage, whether this run compiled
    # the kernels, each solve's wall and f64 re-solves
    result["setup"] = {"compiled": run.compiled,
                       "stages": run.setup_stages}
    result["solves"] = [[round(r["seconds"], 4), r["f64_resolves"]]
                        for r in run.solves]
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_by_span()}
    result["checks"] = checks
    return result


def device_record(dev, run: Run) -> dict:
    import torch
    on_card = dev.type == "cuda"
    out = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace is not None:
        out["busy_s"] = run.trace.busy_s()
        out["window_s"] = run.trace.window_s
    return out


# ---------------------------------------------------------------------------
# correct: the window's solves against the plain reference
# ---------------------------------------------------------------------------

def reference_sectors(config: dict, ns: int) -> List[tuple]:
    """The sectors the reference searches for the ground state: the
    half-filled one and its neighbours within ``shift``."""
    shift = config["reference"]["sectors_around_half_filling"]
    h, _ = half_filling(ns)
    return [(a, b) for a in range(h - shift, h + shift + 1)
            for b in range(h - shift, h + shift + 1)]


def gaps(rec: dict, sol) -> dict:
    """The numbers compared for one solve: sector sets (mismatch count),
    |egs gap|, the widest G and Sigma gaps over max|reference| (of the
    spins the program solves), and the widest density and
    double-occupancy gaps."""
    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())
    nspin = rec["g"].shape[0]
    return {"sector": float(rec["sectors"] != sol.sectors),
            "egs_gap": abs(rec["egs"] - sol.egs),
            "g_gap": rel(rec["g"], sol.g[:nspin]),
            "sigma_gap": rel(rec["sigma"], sol.sigma[:nspin]),
            "dens_gap": float(np.abs(rec["dens"] - sol.dens).max()),
            "docc_gap": float(np.abs(rec["docc"] - sol.docc).max())}


def sample(n: int, k: int, seed: int) -> List[int]:
    """``k`` of ``n`` solves, drawn from the seed."""
    rng = np.random.Generator(np.random.PCG64([int(seed), 7]))
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def reference_solve(cell: Cell, bath: dict, seed: int, dev, dtype=None):
    import torch
    from reference.cluster_ed import solve
    problem = cell.reference.problem(cell.config, bath)
    return solve(problem, reference_sectors(cell.config, problem.ns),
                 dtype=dtype or torch.float64, device=dev,
                 seed=int(seed) % (2 ** 31),
                 batch=cell.config["reference"].get("batch", 0))


def check_solves(run: Run, cell: Cell, seed: int, dev, log,
                 dtype=None) -> tuple:
    """({name: {"value", "limit"}}, solves failed) over a sample of the
    window's solves; every number is the worst over the sample, NaN
    counts as failed."""
    limits = cell.config["limits"]
    worst = {k: 0.0 for k in limits}
    failed = 0
    for i in sample(len(run.solves), cell.config["reference"]["check_solves"],
                    seed):
        rec = run.solves[i]
        t0 = time.perf_counter()
        sol = reference_solve(cell, rec["bath"], seed, dev, dtype)
        g = gaps(rec, sol)
        log(f"reference of solve {i}: {time.perf_counter() - t0:.3f} s, "
            f"sectors {rec['sectors']} / {sol.sectors}, residual "
            f"{sol.residual:.3e}")
        bad = False
        for k in worst:
            val = g[k] if math.isfinite(g[k]) else math.inf
            worst[k] = max(worst[k], val)
            bad |= val > limits[k]
        failed += bad
    return ({k: {"value": worst[k], "limit": limits[k]} for k in limits},
            failed)


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def parse(argv):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cli(argv, t_start: float) -> int:
    args = parse(argv)
    root = HERE.parent
    err = sys.stderr

    def log(msg):
        print(f"# {msg}", file=err, flush=True)

    bench = load_json(root / "BENCHMARK.json")
    cell = cell_of(bench, args.workload)
    stages = Stages(t_start)
    import torch
    stages("import_torch")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    try:
        importlib.import_module(PROGRAM)
    except ImportError as exc:
        log(f"the program {PROGRAM} does not import here: {exc}")
        return 2
    stages("import_program")
    with contextlib.redirect_stdout(err):
        result = run_cell(HERE, bench, args.workload, args.seed,
                          args.seconds, bool(args.trace), "cuda", t_start,
                          log, stages)
    found = forbidden_modules()
    if found:
        log(f"modules that must not load were loaded: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
