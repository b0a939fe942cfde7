#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cdmft_lanc_ed_torch) on one card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each on stdout (any failure exits non-zero):

1. build     - nvcc builds every kernel of the port from csrc/, all
               sources at once; prints the card's name and power limit.
2. kernel    - each kernel against its plain PyTorch version on the card
               at the main path's shapes, then timed (CUDA events) beside
               its bound and one PyTorch library call.
3. plaquette - bath-less U=4 half-filled 2x2 plaquette: EGS -6.1027484835,
               dens 1, docc ~0.0718.
4. loop      - the metric-2 CDMFT loop (2x2 plaquette + 2 replica baths,
               Ns=12, U=4, beta=100, lmats=256, lfit=128, nk=10,
               ed_precision="mixed", wmixing 0.6) through EDSolver and
               run_dmft_loop, to convergence (dmft_error 2e-5); density
               4, C4 symmetry, egs at iteration 11 within 5e-5 of the TPU
               run's, and the kernel's launch count must be > 0.
5. kernels   - one line listing every ported kernel.

The last line is {"ok": true, "device": {...}}.  Without CUDA, or without
the package beside this script, it exits non-zero and prints no result.
``--loops N`` runs N loop iterations instead of converging, and
``--profile`` traces them with torch.profiler and prints the device time
by kernel and the device's busy share (exploration, not part of the
default run).
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np

# H100 data-sheet peaks (dense, no sparsity): FP32 outside the tensor
# cores, and HBM bandwidth.  SXM at 700 W; the PCIe part if nvidia-smi
# names one.
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12)}
EGS_PLAQUETTE = -6.1027484835
# f32 with f32 accumulation over D + U terms in another order than cuBLAS:
# the JAX package's own bound for its Pallas kernel (rtol = atol = 2e-4),
# taken relative to the largest entry of the plain result.
KERNEL_TOL = "max|kernel - plain| <= 2e-4 * max|plain|"
# DMFT_BENCH_r05.json: the TPU run stopped at iteration 11 (error 1.943e-5)
# with egs -8.69773223.  Near convergence egs still drifts ~1e-3 per
# iteration, so the port's egs is held to it at that same iteration.
EGS_LOOP, EGS_LOOP_ITER = -8.69773223, 11


def emit(obj):
    print(json.dumps(obj, default=lambda o: o.item()), flush=True)


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def fail(phase, msg):
    log(f"FAILED {phase}: {msg}")
    sys.exit(1)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail("build", f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def nvcc_release(nvcc):
    """The release line of ``nvcc --version``."""
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60)
    return next((ln for ln in out.stdout.splitlines() if "release" in ln),
                out.stdout.strip())


def time_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def fused_bound_ms(b, d, u, peaks):
    """Least time for B fused H·v: operations over the FP32 peak, bytes
    (each input read once, the output written once) over HBM bandwidth."""
    flops = b * (2.0 * d * u * (d + u) + 2.0 * d * u)
    nbytes = b * 4.0 * (3 * d * u + d * d + u * u)
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def phase_kernel(peaks):
    import torch
    from cdmft_lanc_ed_torch.ops import fused
    rng = np.random.default_rng(2024)
    dev = torch.device("cuda")

    def problem(b, d, u):
        def t(*shape):
            return torch.as_tensor(rng.normal(size=shape).astype(
                np.float32)).to(dev)
        lead = (b,) if b else ()
        return (t(*lead, d, u), t(*lead, d, d), t(*lead, u, u),
                t(*lead, d, u))

    checks = []
    worst = 0.0
    for b, d, u in ((4, 1024, 1024), (0, 768, 512), (0, 924, 924),
                    (0, 66, 220), (3, 12, 66)):
        args = problem(b, d, u)
        out = fused.fused_real_matvec(*args)
        torch.cuda.synchronize()
        ref = fused.fused_real_matvec_ref(*args)
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        ok = bool(torch.isfinite(out).all()) and err <= 2e-4 * scale
        checks.append({"shape": [b or 1, d, u], "max_abs_err": err,
                       "max_abs_ref": scale, "ok": ok})
        worst = max(worst, err)
        if not ok:
            emit({"phase": "kernel", "tolerance": KERNEL_TOL,
                  "checks": checks})
            fail("kernel", f"kernel disagrees with its plain version at "
                           f"{(b, d, u)}: {err} > 2e-4 * {scale}")
    timings = []
    for b in (1, 4, 9):
        d = u = 1024
        args = problem(b, d, u)
        diag, hdw, hupT, x = args
        ms = time_ms(lambda: fused.fused_real_matvec(*args))
        plain_ms = time_ms(lambda: fused.fused_real_matvec_ref(*args))
        library_ms = time_ms(lambda: torch.addcmul(
            torch.matmul(hdw, x), diag, x) + torch.matmul(x, hupT))
        bound, by = fused_bound_ms(b, d, u, peaks)
        timings.append({"shape": [b, d, u], "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound,
                        "bound_by": by, "roofline_share": bound / ms,
                        "tflops": b * (2.0 * d * u * (d + u) + 2.0 * d * u)
                        / (ms * 1e-3) / 1e12})
    emit({"phase": "kernel", "tolerance": KERNEL_TOL, "checks": checks,
          "timings": timings})
    return worst, timings[-1]


def plaquette_hloc():
    h = np.zeros((4, 4, 1, 1, 1, 1), np.complex128)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        h[i, j, 0, 0, 0, 0] = h[j, i, 0, 0, 0, 0] = -1.0
    return h


def phase_plaquette(workdir):
    from cdmft_lanc_ed_torch import EDConfig, EDSolver
    t0 = time.time()
    cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=0, uloc=[4.0], lmats=32,
                   lreal=32, ed_verbose=0, ed_precision="mixed",
                   lanc_dim_threshold=16, work_dir=workdir)
    s = EDSolver(cfg)
    s.init_solver()
    s.solve(np.zeros(0), plaquette_hloc())
    egs, dens, docc = s.egs, s.dens().ravel(), s.docc().ravel()
    ok = bool(abs(egs - EGS_PLAQUETTE) < 1e-8
              and np.allclose(dens, 1.0, atol=1e-8)
              and np.allclose(docc, 0.0718, atol=1e-3)
              and np.isfinite(s.sigma_matsubara()).all())
    emit({"phase": "plaquette", "egs": egs, "dens": dens.tolist(),
          "docc": docc.tolist(), "seconds": time.time() - t0, "ok": ok})
    if not ok:
        fail("plaquette", "anchor missed")


def profile_summary(prof, wall_s):
    """Device time by kernel name and the busy share of the device over the
    traced wall time (kernels may overlap, so the share is an upper
    bound on busy time)."""
    rows = []
    total_us = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
            total_us += dev_us
    rows.sort(reverse=True)
    return {"device_s": total_us * 1e-6, "wall_s": wall_s,
            "device_busy_share": total_us * 1e-6 / wall_s,
            "top": [{"name": k[:80], "device_s": us * 1e-6, "count": c}
                    for us, k, c in rows[:15]]}


def phase_loop(workdir, loops, profile=False):
    import torch
    from cdmft_lanc_ed_torch import EDConfig, EDSolver
    from cdmft_lanc_ed_torch.dmft_loop import run_dmft_loop
    from cdmft_lanc_ed_torch.models.hubbard import square_cluster_hk
    from cdmft_lanc_ed_torch.ops import fused

    cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=2, uloc=[4.0],
                   beta=100.0, lmats=256, lreal=32, lfit=128,
                   nloop=loops or 20, dmft_error=2e-5, nsuccess=1,
                   ed_precision="mixed", ed_verbose=1, work_dir=workdir)
    hk, hloc = square_cluster_hk(2, 2, nk=10)
    solver = EDSolver(cfg)
    basis = np.zeros((1, 4, 4, 1, 1, 1, 1), complex)
    for i in range(4):
        basis[0, i, i, 0, 0, 0, 0] = 1.0
    solver.set_hbath(basis, np.linspace(-1.0, 1.0, cfg.nbath)[:, None])
    bath = solver.init_solver()

    per_loop = []
    errors = []
    egs_hist = []
    mark = [time.time()]

    def loop_log(msg):
        log(msg)
        if msg.startswith("  error="):
            now = time.time()
            per_loop.append({"wall_s": now - mark[0],
                             "stages_s": dict(solver.timers.totals)})
            errors.append(float(msg.split("error=")[1].split()[0]))
            egs_hist.append(solver.egs)
            mark[0] = now

    fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            res = run_dmft_loop(solver, hk, hloc, bath, wmixing=0.6,
                                log=loop_log, max_loops=loops or None)
            torch.cuda.synchronize()
    else:
        res = run_dmft_loop(solver, hk, hloc, bath, wmixing=0.6,
                            log=loop_log, max_loops=loops or None)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fused.launches
    if profile:
        emit({"phase": "profile", **profile_summary(prof, wall)})

    dens = float(np.sum(solver.dens()))
    docc = solver.docc().ravel()
    sm = solver.sigma_matsubara()
    finite = bool(np.isfinite(sm).all() and np.isfinite(res.bath).all())
    c4 = bool(np.allclose(docc, docc[0], atol=1e-6) and all(
        abs(sm[i, i, 0, 0, 0, 0, :8] - sm[0, 0, 0, 0, 0, 0, :8]).max()
        < 1e-6 for i in range(1, 4)))
    checks = {"finite": finite, "density_4": abs(dens - 4.0) < 1e-5,
              "c4_symmetry": c4, "kernel_launched": launches > 0}
    if loops:
        fin = [e for e in errors if np.isfinite(e)]
        checks["error_falls"] = len(fin) < 2 or fin[-1] < fin[0]
    else:
        checks["converged"] = bool(res.converged)
        it = min(EGS_LOOP_ITER, len(egs_hist))
        checks["egs_anchor"] = abs(egs_hist[it - 1] - EGS_LOOP) < 5e-5
    emit({"phase": "loop", "iterations": res.iterations,
          "converged": bool(res.converged), "error": res.error,
          "errors": errors, "egs": solver.egs, "egs_per_iteration": egs_hist,
          "egs_anchor": EGS_LOOP, "egs_anchor_iteration": EGS_LOOP_ITER,
          "density": dens, "docc": docc.tolist(), "wall_s": wall,
          "per_loop": per_loop, "fused_real_matvec_launches": launches,
          "checks": checks})
    if not all(checks.values()):
        fail("loop", f"checks failed: {checks}")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loops", type=int, default=0,
                    help="run this many loop iterations instead of "
                         "converging")
    ap.add_argument("--profile", action="store_true",
                    help="trace the loop phase with torch.profiler")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        log("CUDA is not available: the smoke run needs an NVIDIA card")
        return 2
    try:
        from cdmft_lanc_ed_torch import build
    except ImportError as exc:
        log(f"cdmft_lanc_ed_torch is not importable beside this script: "
            f"{exc}")
        return 2
    import tempfile

    t_start = time.time()
    smi = smi_line()
    peaks = PEAKS["pcie" if "pcie" in smi.lower() else "sxm"]
    t0 = time.time()
    built = build.build()
    emit({"phase": "build", "seconds": time.time() - t0,
          "kernels": {k: {"seconds": v["seconds"], "cached": v["cached"]}
                      for k, v in built.items()},
          "ptxas": {k: [ln for ln in v["ptxas"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in built.items()},
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc_release(build.nvcc_path())})

    worst, timing = phase_kernel(peaks)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
        phase_plaquette(wd)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
        launches = phase_loop(wd, args.loops, args.profile)

    emit({"kernels": [{
        "name": "fused_real_matvec", "route": "cuda",
        "source": "cdmft_lanc_ed_torch/csrc/fused_real_matvec.cu",
        "replaces": "cdmft_lanc_ed_tpu/ops/pallas_fused.py:96",
        "launches": launches, "max_abs_err": worst,
        "shape": timing["shape"], "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}],
        "seconds": time.time() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
