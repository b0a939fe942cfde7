"""The port's real eigensolvers against the JAX package's, on physical
sectors of the 2x2 plaquette + 1 replica bath (Ns=8, bucket 128x128).

Tolerances: f64 thick restart 1e-10 in the eigenvalues, the mixed scheme
1e-8 against JAX's mixed and 1e-7 against f64 (the reference's own bound,
tests/test_mixed_baseline_configs.py:41-49), tridiagonal coefficients
1e-10.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import __graft_entry__ as ge
from cdmft_lanc_ed_tpu.ops import lanczos as jl
from cdmft_lanc_ed_tpu.ops import split as js
from cdmft_lanc_ed_torch import EDConfig
from cdmft_lanc_ed_torch.ops import lanczos as tl
from cdmft_lanc_ed_torch.ops import sector_ham as tsh
from cdmft_lanc_ed_torch.ops import split as ts


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One BLAS and one intra-op thread: the suite runs in several worker
    processes at once, and numpy's spinning OpenBLAS pools would
    oversubscribe the cores many times over."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(nthreads)


NEIGEN, NCV, MAXITER, TOL = 2, 20, 2000, 1e-18


def _ops(nup, ndw):
    jcfg, jop = ge._plaquette_bath_op(nbath=1, nup=nup, ndw=ndw)
    cfg = EDConfig(**dataclasses.asdict(jcfg))
    nn = (4, 4, 1, 1, 1, 1)
    hloc = np.zeros(nn, np.complex128)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        hloc[i, j, 0, 0, 0, 0] = hloc[j, i, 0, 0, 0, 0] = -1.0
    hrec = np.zeros((1,) + nn, np.complex128)
    for il in range(4):
        hrec[0, il, il, 0, 0, 0, 0] = -1.0
    top = tsh.build_sector_operator(cfg, hloc, hrec, np.full((4, 1, 1, 1),
                                                              0.5), nup, ndw)
    return jop, top


@pytest.fixture(scope="module")
def sector():
    jop, top = _ops(4, 4)
    jkit = js.build_real_padded(jop)
    tkit = ts.build_real_padded(top, device="cpu")
    v0 = jkit[2](np.random.default_rng(8527).normal(size=top.dim))
    return jop, top, jkit, tkit, v0


@pytest.fixture(scope="module")
def f64_pair(sector):
    jop, top, jkit, tkit, v0 = sector
    jr = jl.lanczos_eigh_real(js.apply_real_flat, jkit[1], neigen=NEIGEN,
                              ncv=NCV, maxiter=MAXITER, tol=TOL, v0=v0,
                              op=jkit[0])
    tr = tl.lanczos_eigh_real(ts.apply_real_flat, tkit[1], neigen=NEIGEN,
                              ncv=NCV, maxiter=MAXITER, tol=TOL, v0=v0,
                              op=tkit[0])
    return jr, tr


def test_lanczos_eigh_real_f64(sector, f64_pair):
    jr, tr = f64_pair
    np.testing.assert_allclose(tr.eigenvalues, np.asarray(jr.eigenvalues),
                               rtol=0, atol=1e-10)
    assert tr.converged
    # eigenvectors agree up to sign
    for a, b in zip(tr.eigenvectors, np.asarray(jr.eigenvectors)):
        assert abs(abs(float(a @ b)) - 1.0) < 1e-8
    top = sector[1]
    w0 = np.linalg.eigvalsh(top.to_dense().real)[:NEIGEN]
    np.testing.assert_allclose(tr.eigenvalues, w0, rtol=0, atol=1e-10)


def test_lanczos_eigh_mixed_real(sector, f64_pair):
    jop, top, jkit, tkit, v0 = sector
    j32 = js.build_real_padded(jop, dtype=jnp.float32)[0]
    t32 = ts.build_real_padded(top, dtype=torch.float32, device="cpu")[0]
    jr = jl.lanczos_eigh_mixed_real(js.apply_real_flat, js.apply_real_flat,
                                    jkit[1], neigen=NEIGEN, ncv=NCV,
                                    maxiter=MAXITER, tol=TOL, v0=v0,
                                    op32=j32, op64=jkit[0])
    tl.f64_fallbacks = 0
    tr = tl.lanczos_eigh_mixed_real(ts.apply_real_flat, ts.apply_real_flat,
                                    tkit[1], neigen=NEIGEN, ncv=NCV,
                                    maxiter=MAXITER, tol=TOL, v0=v0,
                                    op32=t32, op64=tkit[0])
    # no check of tr.converged: here the refine misses 1e-10 on both
    # sides and the f64 fallback, started from the refined ground vector,
    # can stall on the second pair in either package (its verdict turns
    # on rounding); the eigenvalues are what both certify
    assert tl.f64_fallbacks == 1
    np.testing.assert_allclose(tr.eigenvalues, np.asarray(jr.eigenvalues),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(tr.eigenvalues, f64_pair[1].eigenvalues,
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("mixed", [False, True])
def test_batched_solvers(mixed):
    keys = ((2, 3), (2, 5))            # one bucket (56, 28), dims 1568
    pairs = [_ops(*k) for k in keys]
    pad = (ts._bucket(pairs[0][1].dim_dw), ts._bucket(pairs[0][1].dim_up))
    rng = np.random.default_rng(8527)
    v0 = np.stack([js.embed_real(rng.normal(size=t.dim), t.dim_dw,
                                 t.dim_up, *pad) for _, t in pairs])
    kw = dict(neigen=NEIGEN, ncv=NCV, maxiter=MAXITER, tol=TOL, v0=v0)
    dim_p = pad[0] * pad[1]
    jops = [p[0] for p in pairs]
    tops = [p[1] for p in pairs]
    if mixed:
        jres = jl.lanczos_eigh_mixed_real_batched(
            js.apply_real_flat_batched, js.apply_real_flat_batched, 2, dim_p,
            op32=js.stack_real_ops(jops, pad, dtype=jnp.float32),
            op64=js.stack_real_ops(jops, pad), **kw)
        tres = tl.lanczos_eigh_mixed_real_batched(
            ts.apply_real_flat_batched, ts.apply_real_flat_batched, 2, dim_p,
            op32=ts.stack_real_ops(tops, pad, dtype=torch.float32),
            op64=ts.stack_real_ops(tops, pad), **kw)
        atol = 1e-8
    else:
        jres = jl.lanczos_eigh_real_batched(
            js.apply_real_flat_batched, 2, dim_p,
            op=js.stack_real_ops(jops, pad), **kw)
        tres = tl.lanczos_eigh_real_batched(
            ts.apply_real_flat_batched, 2, dim_p,
            op=ts.stack_real_ops(tops, pad), **kw)
        atol = 1e-10
    for jr, tr, top in zip(jres, tres, tops):
        np.testing.assert_allclose(tr.eigenvalues,
                                   np.asarray(jr.eigenvalues), rtol=0,
                                   atol=atol)
        w0 = np.linalg.eigvalsh(top.to_dense().real)[:NEIGEN]
        np.testing.assert_allclose(tr.eigenvalues, w0, rtol=0, atol=1e-7)


def test_lanczos_tridiag_batched_real(sector):
    jop, top, jkit, tkit, _ = sector
    rng = np.random.default_rng(4)
    v0 = np.stack([jkit[2](rng.normal(size=top.dim)) for _ in range(3)])
    ja, jb, jn = jl.lanczos_tridiag_batched_real(js.apply_real_flat, v0, 32,
                                                 op=jkit[0])
    ta, tb, tn = tl.lanczos_tridiag_batched_real(ts.apply_real_flat, v0, 32,
                                                 op=tkit[0])
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tn, jn, rtol=1e-14)
