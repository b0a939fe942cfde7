#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cdmft_lanc_ed_torch) on one card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each on stdout (any failure exits non-zero):

1. build       - nvcc builds every kernel of the port from csrc/, all
                 sources at once; prints the card's name and power limit.
2. kernel      - the real kernel against its plain PyTorch version on the
                 card at the main path's shapes, then timed (CUDA events)
                 beside its bound and one PyTorch library call.
3. pair_kernel - the same for the complex kernel (complex64).  Each check
                 also reports the error of the plain version on inputs
                 rounded to TF32 (a control: what a TF32 kernel would
                 show).
4. plaquette   - bath-less U=4 half-filled 2x2 plaquette: EGS
                 -6.1027484835, dens 1, docc ~0.0718.
5. loop        - the metric-2 CDMFT loop (2x2 plaquette + 2 replica baths,
                 Ns=12, U=4, beta=100, lmats=256, lfit=128, nk=10,
                 ed_precision="mixed", wmixing 0.6) through EDSolver and
                 run_dmft_loop, to convergence (dmft_error 2e-5); density
                 4, C4 symmetry, egs at iteration 11 within 5e-5 of the
                 TPU run's, and the real kernel's launch count must be > 0.
6. bhz_solve   - the BHZ chain (2-site cluster, 2 orbitals, 2 spins, 2
                 general baths: Ns=12, complex sectors) solved once at its
                 initial bath in "mixed" and in "complex128": egs to 1e-7
                 and Sigma to 5e-5 relative between the two, everything
                 finite, the spin-up and spin-down diagonals of Sigma
                 equal (time reversal), complex kernel launches > 0;
                 counts the sectors the mixed solve re-solved in f64.
7. bhz_loop    - the same configuration through run_dmft_loop for 2
                 iterations ("mixed", wmixing 0.5): finite, time reversal
                 kept, complex kernel launches > 0; wall and stage times
                 per iteration.
8. kernels     - one line listing every ported kernel.

The last line is {"ok": true, "device": {...}}.  Without CUDA, or without
the package beside this script, it exits non-zero and prints no result.
``--loops N`` runs N loop iterations instead of converging, and
``--profile`` traces both loop phases with torch.profiler and prints the
device time by kernel and the device's busy share (exploration, not part
of the default run).
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
# The complex kernel sums three Karatsuba products (Im = P3 - P1 - P2
# cancels): the JAX package's bound for its complex Pallas kernel,
# rtol = atol = 1e-3 (tests/test_pallas_fused.py:73-76).
PAIR_TOL = "max|kernel - plain| <= 1e-3 * max|plain|"
# That bound would pass TF32 products (3e-4 * max|plain| here), which the
# kernels must not use: each error is also held to a tenth of the plain
# version's error on TF32-rounded inputs (IEEE f32 measured 78x below).
TF32_TOL = ", and <= 0.1 * the TF32 control"
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


def fused_cost(b, d, u, complex_):
    """(FLOPs, compulsory bytes) of B fused H·v.  Real: 2·D·U·(D+U) +
    2·D·U in f32.  Complex: 6·D·U·(D+U) + 4·D·U, the TPU kernel's own
    count of its Karatsuba form (pallas_fused.py:188-191), with complex64
    operands and a real f32 diag.  Bytes read each input once and write
    the output once."""
    if complex_:
        return (b * (6.0 * d * u * (d + u) + 4.0 * d * u),
                b * (4.0 * d * u + 8.0 * (2 * d * u + d * d + u * u)))
    return (b * (2.0 * d * u * (d + u) + 2.0 * d * u),
            b * 4.0 * (3 * d * u + d * d + u * u))


def fused_bound_ms(b, d, u, peaks, complex_=False):
    """Least time for B fused H·v: operations over the FP32 peak, bytes
    over HBM bandwidth."""
    flops, nbytes = fused_cost(b, d, u, complex_)
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def tf32_round(a):
    """``a`` (float32 or complex64) with every float rounded to TF32's
    10-bit mantissa, to nearest."""
    import torch
    f = torch.view_as_real(a) if a.is_complex() else a
    i = f.contiguous().view(torch.int32)
    r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.view_as_complex(r) if a.is_complex() else r


def kernel_phase(name, peaks, complex_, shapes, rel_tol, tol_text):
    """Check kernel ``name`` (fused_real_matvec or fused_pair_matvec)
    against its plain version at ``shapes`` [(B, D, U, shared_op)], then
    time it, the plain version and one library call at B = 1, 4, 9 on the
    1024 bucket.  Returns (worst error, timing at B = 9)."""
    import torch
    from cdmft_lanc_ed_torch.ops import fused
    kernel = getattr(fused, name)
    plain = getattr(fused, name + "_ref")
    phase = "pair_kernel" if complex_ else "kernel"
    rng = np.random.default_rng(2024)
    dev = torch.device("cuda")

    def t(*shape, cplx=False):
        a = rng.normal(size=shape)
        if cplx:
            a = a + 1j * rng.normal(size=shape)
            return torch.as_tensor(a.astype(np.complex64)).to(dev)
        return torch.as_tensor(a.astype(np.float32)).to(dev)

    def problem(b, d, u, shared=False):
        lead = (b,) if b and not shared else ()
        xlead = (b,) if b else ()
        return (t(*lead, d, u), t(*lead, d, d, cplx=complex_),
                t(*lead, u, u, cplx=complex_),
                t(*xlead, d, u, cplx=complex_))

    checks = []
    worst = 0.0
    for b, d, u, shared in shapes:
        args = problem(b, d, u, shared)
        out = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        # control: the error of a product whose inputs were rounded to
        # TF32, the tensor cores' f32 mode; IEEE f32 stays 10x below it
        tf32_err = float((plain(*map(tf32_round, args)) - ref).abs().max())
        ok = bool(torch.isfinite(out).all()) and err <= rel_tol * scale \
            and err <= 0.1 * tf32_err
        checks.append({"shape": [b or 1, d, u], "shared_operator": shared,
                       "max_abs_err": err, "max_abs_ref": scale,
                       "tf32_control_err": tf32_err, "ok": ok})
        worst = max(worst, err)
        if not ok:
            emit({"phase": phase, "tolerance": tol_text + TF32_TOL,
                  "checks": checks})
            fail(phase, f"{name} disagrees with its plain version at "
                        f"{(b, d, u)}: error {err}, max|plain| {scale}, "
                        f"TF32 control {tf32_err}")
    timings = []
    for b in (1, 4, 9):
        d = u = 1024
        args = problem(b, d, u)
        diag, hdw, hupT, x = args
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: plain(*args))
        library_ms = time_ms(lambda: torch.addcmul(
            torch.matmul(hdw, x), diag, x) + torch.matmul(x, hupT))
        bound, by = fused_bound_ms(b, d, u, peaks, complex_)
        flops = fused_cost(b, d, u, complex_)[0]
        timings.append({"shape": [b, d, u], "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound,
                        "bound_by": by, "roofline_share": bound / ms,
                        "tflops": flops / (ms * 1e-3) / 1e12})
    emit({"phase": phase, "tolerance": tol_text + TF32_TOL,
          "checks": checks, "timings": timings})
    return worst, timings[-1]


def phase_kernel(peaks):
    return kernel_phase(
        "fused_real_matvec", peaks, False,
        ((4, 1024, 1024, False), (0, 768, 512, False),
         (0, 924, 924, False), (0, 66, 220, False), (3, 12, 66, False)),
        2e-4, KERNEL_TOL)


def phase_pair_kernel(peaks):
    return kernel_phase(
        "fused_pair_matvec", peaks, True,
        ((4, 1024, 1024, False), (4, 924, 924, False),
         (0, 66, 220, False), (3, 12, 66, True)),
        1e-3, PAIR_TOL)


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
    """Device time by kernel, the busy share of the device over the traced
    wall time (kernels on one stream, so the sum is the busy time), and
    the CPU ops whose kernels took the most device time.  A CPU op's
    device time repeats that of the kernels it launched, so only
    device-side rows count towards the busy time."""
    from torch.autograd import DeviceType
    kernels, ops = [], []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows = ops if ev.device_type == DeviceType.CPU else kernels
            rows.append((dev_us, ev.key, ev.count))
    busy_s = sum(r[0] for r in kernels) * 1e-6

    def top(rows):
        return [{"name": k[:80], "device_s": us * 1e-6, "count": c}
                for us, k, c in sorted(rows, reverse=True)[:15]]

    return {"device_s": busy_s, "wall_s": wall_s,
            "device_busy_share": busy_s / wall_s, "top": top(kernels),
            "top_ops": top(ops)}


def traced(profile, phase, fn):
    """fn(), under torch.profiler when ``profile`` (then one ``profile``
    line for ``phase``).  Returns (fn's result, wall seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.time()
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            res = fn()
            torch.cuda.synchronize()
    else:
        res = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    if profile:
        emit({"phase": "profile", "of": phase,
              **profile_summary(prof, wall)})
    return res, wall


def phase_loop(workdir, loops, profile=False):
    from cdmft_lanc_ed_torch import EDConfig, EDSolver
    from cdmft_lanc_ed_torch.dmft_loop import run_dmft_loop
    from cdmft_lanc_ed_torch.models.hubbard import square_cluster_hk
    from cdmft_lanc_ed_torch.ops import fused, lanczos

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

    fused.launches = fused.pair_launches = 0
    lanczos.f64_fallbacks = 0
    res, wall = traced(profile, "loop", lambda: run_dmft_loop(
        solver, hk, hloc, bath, wmixing=0.6, log=loop_log,
        max_loops=loops or None))
    launches, pair_launches = fused.launches, fused.pair_launches
    fallbacks = lanczos.f64_fallbacks

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
          "fused_pair_matvec_launches": pair_launches,
          "f64_fallbacks": fallbacks, "checks": checks})
    if not all(checks.values()):
        fail("loop", f"checks failed: {checks}")
    return launches


# The BHZ chain of drivers/cdn_bhz_1d.py at full width: a 2-site cluster,
# 2 orbitals, 2 spins, 2 general baths (Ns = 12), BASELINE config 5's
# interaction.  Its sectors are complex, (5..7, 5..7) with 924x924 spin
# factors in the 1024 bucket.
BHZ_CFG = dict(nlat=2, norb=2, nspin=2, nbath=2, bath_type="general",
               uloc=[2.0, 2.0], ust=0.5, beta=100.0, lmats=256, lreal=32,
               lfit=128)
BHZ_MODEL = dict(mh=1.0, ts=0.25, lam=0.3)
# Time reversal maps H_up to its complex conjugate H_dw here
# (models/bhz.py:31-33), so the spin-up and spin-down diagonals of Sigma
# agree; the bound is the JAX suite's mixed-vs-f64 Sigma bound.
TR_TOL = 5e-5


def bhz_setup(workdir, prec, verbose=0):
    from cdmft_lanc_ed_torch import EDConfig, EDSolver
    from cdmft_lanc_ed_torch.models.bhz import bhz_bath_basis, bhz_chain_hk
    cfg = EDConfig(**BHZ_CFG, ed_precision=prec, ed_verbose=verbose,
                   work_dir=workdir)
    hk, hloc = bhz_chain_hk(2, 1, 32, **BHZ_MODEL)
    solver = EDSolver(cfg)
    basis, lam0 = bhz_bath_basis(2, 1, **BHZ_MODEL)
    solver.set_hbath(basis, np.tile(lam0, (cfg.nbath, 1)))
    bath = solver.init_solver()
    return solver, bath, hk, hloc


def tr_gap(sm):
    """max |Sigma_up,aa - Sigma_dw,aa| over sites and orbitals, relative
    to max |Sigma|."""
    nlat, norb = sm.shape[0], sm.shape[4]
    gap = max(float(np.abs(sm[i, i, 0, 0, o, o] - sm[i, i, 1, 1, o, o])
                    .max()) for i in range(nlat) for o in range(norb))
    return gap / float(np.abs(sm).max())


def phase_bhz_solve(workdir):
    import torch
    from cdmft_lanc_ed_torch.ops import fused, lanczos
    out = {}
    for prec in ("mixed", "complex128"):
        solver, bath, _, hloc = bhz_setup(workdir, prec)
        fused.launches = fused.pair_launches = 0
        lanczos.f64_fallbacks = 0
        torch.cuda.synchronize()
        t0 = time.time()
        solver.solve(bath, hloc)
        torch.cuda.synchronize()
        out[prec] = dict(
            egs=solver.egs, sigma=solver.sigma_matsubara(),
            dens=solver.dens(), seconds=time.time() - t0,
            stages_s=dict(solver.timers.totals),
            pair_launches=fused.pair_launches,
            real_launches=fused.launches,
            f64_fallbacks=lanczos.f64_fallbacks)
    mx, f64 = out["mixed"], out["complex128"]
    sig_err = float(np.abs(mx["sigma"] - f64["sigma"]).max()
                    / np.abs(f64["sigma"]).max())
    checks = {
        "finite": all(bool(np.isfinite(r["sigma"]).all()
                           and np.isfinite(r["egs"])) for r in out.values()),
        "egs_mixed_vs_f64": abs(mx["egs"] - f64["egs"]) < 1e-7,
        "sigma_mixed_vs_f64": sig_err < 5e-5,
        "time_reversal": all(tr_gap(r["sigma"]) < TR_TOL
                             for r in out.values()),
        "kernel_launched": mx["pair_launches"] > 0}
    emit({"phase": "bhz_solve",
          "egs": {k: r["egs"] for k, r in out.items()},
          "egs_diff": abs(mx["egs"] - f64["egs"]),
          "sigma_rel_err": sig_err,
          "tr_gap": {k: tr_gap(r["sigma"]) for k, r in out.items()},
          "density": {k: float(np.sum(r["dens"])) for k, r in out.items()},
          "seconds": {k: r["seconds"] for k, r in out.items()},
          "stages_s": {k: r["stages_s"] for k, r in out.items()},
          "fused_pair_matvec_launches": {k: r["pair_launches"]
                                         for k, r in out.items()},
          "fused_real_matvec_launches": {k: r["real_launches"]
                                         for k, r in out.items()},
          "f64_fallbacks": mx["f64_fallbacks"],
          "checks": checks})
    if not all(checks.values()):
        fail("bhz_solve", f"checks failed: {checks}")


def phase_bhz_loop(workdir, loops, profile=False):
    import torch
    from cdmft_lanc_ed_torch.dmft_loop import run_dmft_loop
    from cdmft_lanc_ed_torch.ops import fused, lanczos
    solver, bath, hk, hloc = bhz_setup(workdir, "mixed", verbose=1)
    per_loop = []
    mark = [time.time()]

    def loop_log(msg):
        log(msg)
        if msg.startswith("  error="):
            torch.cuda.synchronize()
            now = time.time()
            per_loop.append({
                "wall_s": now - mark[0],
                "stages_s": dict(solver.timers.totals),
                "error": float(msg.split("error=")[1].split()[0]),
                "egs": solver.egs,
                "tr_gap": tr_gap(solver.sigma_matsubara()),
                "pair_launches": fused.pair_launches,
                "f64_fallbacks": lanczos.f64_fallbacks})
            mark[0] = now

    fused.launches = fused.pair_launches = 0
    lanczos.f64_fallbacks = 0
    res, wall = traced(profile, "bhz_loop", lambda: run_dmft_loop(
        solver, hk, hloc, bath, wmixing=0.5, log=loop_log, max_loops=loops))
    launches, pair_launches = fused.launches, fused.pair_launches
    sm = solver.sigma_matsubara()
    checks = {"finite": bool(np.isfinite(sm).all()
                             and np.isfinite(res.bath).all()
                             and np.isfinite(res.weiss).all()),
              "iterations": res.iterations == loops,
              "time_reversal": tr_gap(sm) < TR_TOL,
              "kernel_launched": pair_launches > 0}
    emit({"phase": "bhz_loop", "iterations": res.iterations,
          "errors": [r["error"] for r in per_loop],
          "egs_per_iteration": [r["egs"] for r in per_loop],
          "density": float(np.sum(solver.dens())), "wall_s": wall,
          "per_loop": per_loop, "fused_pair_matvec_launches": pair_launches,
          "fused_real_matvec_launches": launches, "checks": checks})
    if not all(checks.values()):
        fail("bhz_loop", f"checks failed: {checks}")
    return pair_launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loops", type=int, default=0,
                    help="run this many loop iterations instead of "
                         "converging")
    ap.add_argument("--profile", action="store_true",
                    help="trace both loop phases with torch.profiler")
    ap.add_argument("--bhz-loops", type=int, default=2,
                    help="iterations of the BHZ loop phase")
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
    pair_worst, pair_timing = phase_pair_kernel(peaks)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
        phase_plaquette(wd)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
        launches = phase_loop(wd, args.loops, args.profile)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
        phase_bhz_solve(wd)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
        pair_launches = phase_bhz_loop(wd, args.bhz_loops, args.profile)

    def entry(name, line, n, err, tm):
        return {"name": name, "route": "cuda",
                "source": f"cdmft_lanc_ed_torch/csrc/{name}.cu",
                "replaces": f"cdmft_lanc_ed_tpu/ops/pallas_fused.py:{line}",
                "launches": n, "max_abs_err": err, "shape": tm["shape"],
                "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                "library_ms": tm["library_ms"]}

    emit({"kernels": [
        entry("fused_real_matvec", 96, launches, worst, timing),
        entry("fused_pair_matvec", 179, pair_launches, pair_worst,
              pair_timing)],
        "seconds": time.time() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
