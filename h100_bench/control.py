#!/usr/bin/env python3
"""The lower-precision controls of a cell's checks, at the cell's size:

    python3 h100_bench/control.py --workload <cell> --seeds 1,2,3 \
        --kind reference_f32|program_gf_single --out runs/controls.jsonl

``reference_f32`` puts the plain reference, computed in float32, in the
program's place; ``program_gf_single`` runs the program with its own
lower-precision path switched on (``ed_gf_precision="single"``: f32 GF
chains).  Each seed's first bath is solved by the control and by the
float64 reference, and the numbers the run's checks compare are printed
beside the cell's limits: the control has to exceed one of them.  Not
part of a benchmark run.
"""
import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def solution_record(sol) -> dict:
    return {"sectors": sol.sectors, "egs": sol.egs, "g": sol.g,
            "sigma": sol.sigma, "dens": sol.dens, "docc": sol.docc}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--kind", required=True,
                   choices=("reference_f32", "program_gf_single"))
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    sys.path.insert(0, str(HERE.parent))
    import torch
    import harness
    import traffic as traffic_gen
    bench = harness.load_json(HERE.parent / "BENCHMARK.json")
    cell = harness.load_cell(HERE, bench, a.workload)
    dev = torch.device(a.device)
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in a.seeds.split(",")):
        bath = next(traffic_gen.baths(cell.model, cell.config,
                                      cell.traffic["amplitude"], seed,
                                      cell.traffic.get("pool")))
        t0 = time.perf_counter()
        if a.kind == "reference_f32":
            rec = solution_record(harness.reference_solve(
                cell, bath, seed, dev, torch.float32))
        else:
            wd = tempfile.mkdtemp(prefix="h100_bench_control_")
            try:
                solver = harness.make_solver(cell, wd, dev,
                                             ed_gf_precision="single")
                solver.solve(cell.model.bath_array(cell.config, bath),
                             cell.model.hloc(cell.config,
                                             cell.reference))
                rec = harness._record(solver, bath, 0.0)
                del solver
            finally:
                shutil.rmtree(wd, ignore_errors=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ref = harness.reference_solve(cell, bath, seed, dev)
        g = harness.gaps(rec, ref)
        line = {"workload": a.workload, "kind": a.kind, "seed": seed,
                "control_s": t1 - t0,
                "reference_s": time.perf_counter() - t1,
                "gaps": g, "limits": cell.config["limits"],
                "fails": [k for k in g
                          if g[k] > cell.config["limits"][k]]}
        with open(out, "a") as fh:
            fh.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
