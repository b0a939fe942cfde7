#!/usr/bin/env python3
"""The metric-2 CDMFT loop of chip_smoke.py in one ED precision, on the card.

    python3 metric2_precision.py --precision complex128
    python3 metric2_precision.py --precision mixed --cg-ftol 1e-12

Runs the loop to convergence and prints one JSON line: the iteration
count, the error and egs of every iteration, and egs at the iteration of
the TPU run's anchor beside that anchor.  Run the
two precisions at the same ``--cg-ftol`` to see whether they follow one
trajectory: a chi^2 fit stopped early in a flat valley turns last-digit
differences of the solve into different baths, a fit driven to its
minimum should not.
"""
import argparse
import json
import sys
import tempfile
import time

import numpy as np

import chip_smoke


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--precision", choices=("mixed", "complex128"),
                    required=True)
    ap.add_argument("--cg-ftol", type=float, default=None,
                    help="the fit's tolerance (default: EDConfig's)")
    ap.add_argument("--cg-niter", type=int, default=None,
                    help="the fit's iteration cap (default: EDConfig's)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("CUDA is not available: this run needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from cdmft_lanc_ed_torch.dmft_loop import run_dmft_loop

    fit = {k: v for k, v in (("cg_ftol", args.cg_ftol),
                             ("cg_niter", args.cg_niter)) if v is not None}
    errors, egs = [], []
    with tempfile.TemporaryDirectory(prefix="metric2_") as wd:
        solver, bath, hk, hloc = chip_smoke.metric2_setup(
            wd, ed_precision=args.precision, ed_verbose=0, **fit)

        def log(msg):
            if msg.startswith("  error="):
                errors.append(float(msg.split("error=")[1].split()[0]))
                egs.append(solver.egs)

        t0 = time.time()
        res = run_dmft_loop(solver, hk, hloc, bath, wmixing=0.6, log=log)
        wall = time.time() - t0
    it = chip_smoke.EGS_LOOP_ITER
    at = egs[it - 1] if len(egs) >= it else None
    print(json.dumps({
        "precision": args.precision, "cg_ftol": solver.cfg.cg_ftol,
        "cg_niter": solver.cfg.cg_niter, "iterations": res.iterations,
        "converged": bool(res.converged), "errors": errors,
        "egs_per_iteration": egs, "anchor_iteration": it,
        "egs_anchor": chip_smoke.EGS_LOOP, "egs_at_anchor_iteration": at,
        "egs_anchor_gap": None if at is None
        else abs(at - chip_smoke.EGS_LOOP),
        "finite": bool(np.isfinite(res.bath).all()), "wall_s": wall,
        "card": chip_smoke.smi_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
