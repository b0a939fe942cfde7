"""Shared set-up of the benchmark's own tests: the benchmark's modules on
the path, and a throw-away benchmark directory at a CPU size."""
import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the Ns=8 plaquette (one replica bath at level 0): the cell's layers at a
# size the CPU solves in seconds
TINY = {"nbath": 1, "lmats": 64, "lanc_ngfiter": 60}
TINY_BATH = {"levels": [0.0], "v": [0.5]}


def copy_bench(tmp: Path) -> Path:
    """A copy of the benchmark's files (no tests) under ``tmp``: what a
    later change that adds files starts from."""
    d = tmp / "bench"
    shutil.copytree(BENCH, d, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    return d


def tiny_bench(tmp: Path, traffic: str = "full_sweep"):
    """(bench dir, BENCHMARK dict, cell name) of a one-cell benchmark on a
    copy of the Ns=12 configuration cut to Ns=8, written under ``tmp``."""
    d = copy_bench(tmp)
    cfg = json.loads((BENCH / "configs" / "plaquette_ns12.json").read_text())
    cfg["bath"] = dict(TINY_BATH)
    cfg["ed"].update(TINY)
    (d / "configs" / "tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = f"tiny.{traffic}"
    bench["workloads"] = [{"name": cell, "config": "tiny",
                           "traffic": traffic, "chips": 1, "why": "test"}]
    keep = {"setup_s", "solve_s", "diag_s.ns12", "gf_s.ns12",
            "f64_resolves.ns12", "real_kernel_roofline.ns12",
            "device_idle.ns12"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = [cell] if m["name"] in keep else []
    return d, bench, cell


def tiny_config(d: Path) -> dict:
    return json.loads((d / "configs" / "tiny.json").read_text())
