#!/usr/bin/env python3
"""Which Lanczos sectors the mixed-precision solver re-solves in f64, in
the PyTorch port and in the JAX package, on the complex BHZ case of
tests/bhz_case.py (Ns=6, CPU).

    python tools/torch_fallback_compare.py

Both packages run one ``ed_precision="mixed"`` solve at the initial bath
(the JAX package on its split-plane kit, CDMFT_SPLIT_BACKEND=1).  For
each batched f64 refine it prints the padded sector dimension, the worst
wanted residual of every expansion round and the rounds taken; then the
f64 re-solves (calls of the serial eigensolver, the port's ``eigh`` and
the JAX package's ``lanczos_eigh_split``, at f64) by padded dimension.
One JSON line per package.
"""
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["CDMFT_SPLIT_BACKEND"] = "1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402

import bhz_case  # noqa: E402
import cdmft_lanc_ed_torch as tpkg  # noqa: E402
import cdmft_lanc_ed_tpu as jpkg  # noqa: E402
from cdmft_lanc_ed_torch.models import bhz as tbhz  # noqa: E402
from cdmft_lanc_ed_torch.ops import lanczos as tl  # noqa: E402
from cdmft_lanc_ed_tpu.ops import lanczos as jl  # noqa: E402


def instrument(mod, refine_name, eigh_name, record):
    """Wrap ``mod``'s stall guard, batched complex refine and serial
    complex eigensolver so that one solve fills ``record``."""
    rounds = []
    stalled = mod._RefineStall.stalled

    def spy_stalled(self, cur):
        rounds.append(cur)
        return stalled(self, cur)

    refine = getattr(mod, refine_name)

    def spy_refine(*a, **k):
        rounds.clear()
        out = refine(*a, **k)
        record["refines"].append({"dim": int(np.shape(out[1])[-1]),
                                  "worst_per_round": list(rounds)})
        return out

    eigh = getattr(mod, eigh_name)

    def spy_eigh(apply_fn, dim, *a, **k):
        out = eigh(apply_fn, dim, *a, **k)
        # the Krylov stage runs at float32/complex64; a re-solve at f64
        if not any(t in str(k.get("dtype")) for t in ("32", "complex64")):
            record["f64_resolves"].append(int(dim))
        return out

    mod._RefineStall.stalled = spy_stalled
    setattr(mod, refine_name, spy_refine)
    setattr(mod, eigh_name, spy_eigh)


def main():
    _, basis, lams = bhz_case.model(tbhz)
    _, hloc = bhz_case.lattice(tbhz)
    for pkg, mod, refine, eigh, kw in (
            (tpkg, tl, "rayleigh_refine_batched", "eigh", {"device": "cpu"}),
            (jpkg, jl, "rayleigh_refine_split_batched", "lanczos_eigh_split",
             {})):
        record = {"refines": [], "f64_resolves": []}
        instrument(mod, refine, eigh, record)
        with tempfile.TemporaryDirectory() as wd:
            cfg = pkg.EDConfig(**bhz_case.KW, ed_precision="mixed",
                               work_dir=wd)
            solver = pkg.EDSolver(cfg, **kw)
            solver.set_hbath(basis, lams)
            bath = solver.init_solver()
            solver.solve(bath, hloc)
        resolves = record["f64_resolves"]
        print(json.dumps({
            "package": pkg.__name__, "egs": float(solver.egs),
            "refines": [{"dim": r["dim"],
                         "rounds": len(r["worst_per_round"]),
                         "worst_per_round": [float(f"{x:.2e}") for x in
                                             r["worst_per_round"]]}
                        for r in record["refines"]],
            "f64_resolves": len(resolves),
            "f64_resolves_by_dim": {str(d): resolves.count(d)
                                    for d in sorted(set(resolves))}}))


if __name__ == "__main__":
    main()
