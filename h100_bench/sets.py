#!/usr/bin/env python3
"""Runs of one cell, each a fresh process as the check makes them, with
their result lines collected:

    python3 h100_bench/sets.py --workload <cell> --seeds 11,12,13 \
        --seconds 30 --trace 0 --out runs/<file>.jsonl

Each run is ``run.py`` with one seed; its exit code, wall seconds, last
stdout line (the result) and stderr tail go to one line of ``--out``.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    worst = 0
    for seed in a.seeds.split(","):
        cmd = [sys.executable, str(HERE / "run.py"), "--workload",
               a.workload, "--seed", seed, "--seconds", str(a.seconds),
               "--trace", str(a.trace)]
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=HERE.parent)
        lines = proc.stdout.strip().splitlines()
        rec = {"workload": a.workload, "seed": int(seed),
               "trace": a.trace, "rc": proc.returncode,
               "wall_s": time.time() - t0,
               "result": json.loads(lines[-1]) if proc.returncode == 0
               and lines else None,
               "stderr_tail": proc.stderr[-3000:]}
        with open(out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        r = rec["result"] or {}
        print(json.dumps({"seed": rec["seed"], "rc": rec["rc"],
                          "wall_s": round(rec["wall_s"], 2),
                          "correct": r.get("correct"),
                          "attempted": r.get("attempted"),
                          "metrics": {k: v["value"] for k, v in
                                      r.get("metrics", {}).items()},
                          "solves": r.get("solves"),
                          "setup": r.get("setup"),
                          "checks": {k: v["value"] for k, v in
                                     r.get("checks", {}).items()}}),
              flush=True)
        worst = max(worst, proc.returncode)
    return worst


if __name__ == "__main__":
    sys.exit(main())
