"""The port's complex pair kit against the JAX package: the fused complex
H·v wrapper (ops/fused.py), the pair operator (ops/split.py) and the
complex eigensolvers (ops/lanczos.py).

On the CPU the wrapper takes its plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode, as tests/test_pallas_fused.py does,
at its tolerance for this kernel (rtol = atol = 1e-3, three f32 Karatsuba
products).  The operators come from the complex BHZ case of
tests/bhz_case.py.  Tolerances: padded operator arrays bit-equal,
complex128 H·v 1e-12 relative, eigenvalues 1e-10 (f64) and 1e-8 (mixed),
tridiagonal coefficients 1e-10.  A ComplexWarning (an imaginary part
dropped) fails the test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import bhz_case
import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_tpu.ops import lanczos as jl
from cdmft_lanc_ed_tpu.ops import pallas_fused
from cdmft_lanc_ed_tpu.ops import split as jsplit
from cdmft_lanc_ed_torch.ops import fused
from cdmft_lanc_ed_torch.ops import lanczos as tl
from cdmft_lanc_ed_torch.ops import split as tsplit

pytestmark = pytest.mark.filterwarnings(
    "error::numpy.exceptions.ComplexWarning")


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


TOL = dict(rtol=1e-3, atol=1e-3)


def _rand_problem(rng, d, u, b=None):
    """f32 diag, complex64 hdw, hupT and x (a leading batch axis b)."""
    lead = () if b is None else (b,)

    def c(*shape):
        return (rng.normal(size=lead + shape)
                + 1j * rng.normal(size=lead + shape)).astype(np.complex64)

    return (rng.normal(size=lead + (d, u)).astype(np.float32), c(d, d),
            c(u, u), c(d, u))


def _planes(diag, hdw, hupT, x):
    """The JAX kernel's f32 arguments: diag, H_dw r/i/s, H_upᵀ r/i/s,
    x r/i."""
    out = [jnp.asarray(diag)]
    for a in (hdw, hupT):
        out += [jnp.asarray(a.real), jnp.asarray(a.imag),
                jnp.asarray(a.real + a.imag)]
    return out + [jnp.asarray(x.real), jnp.asarray(x.imag)]


def _port(*arrays):
    return fused.fused_pair_matvec(
        *(torch.from_numpy(a) for a in arrays)).numpy()


@pytest.mark.parametrize("d,u", [(128, 128), (256, 128)])
def test_pair_matches_pallas_interpret(d, u):
    rng = np.random.default_rng(7)
    arrays = _rand_problem(rng, d, u)
    launches0 = fused.pair_launches
    wr, wi = pallas_fused.fused_pair_matvec(*_planes(*arrays),
                                            interpret=True)
    ref = np.asarray(wr) + 1j * np.asarray(wi)
    np.testing.assert_allclose(_port(*arrays), ref, **TOL)
    assert fused.pair_launches == launches0      # CPU tensors never launch


def test_pair_batched_matches_vmap():
    """A batch of 3 sectors against the JAX vmap form (the batched
    solver's dispatch)."""
    rng = np.random.default_rng(3)
    arrays = _rand_problem(rng, 128, 128, b=3)
    fn = jax.vmap(lambda *a: pallas_fused.fused_pair_matvec(
        *a, interpret=True))
    wr, wi = fn(*_planes(*arrays))
    np.testing.assert_allclose(_port(*arrays),
                               np.asarray(wr) + 1j * np.asarray(wi), **TOL)


def test_pair_ragged_matches_split():
    """A shape the 128-aligned Pallas kernel cannot take against JAX's
    split.matvec_dense_pair in f32."""
    rng = np.random.default_rng(5)
    arrays = _rand_problem(rng, 66, 220)
    p = _planes(*arrays)
    nd0 = jnp.zeros((0,), jnp.float32)
    dev = jsplit.DenseSplitOp(
        diag=p[0], hdw_r=p[1], hdw_i=p[2], hdw_s=p[3], hupT_r=p[4],
        hupT_i=p[5], hupT_s=p[6], nd_amp_r=nd0, nd_amp_i=nd0,
        nd_upT=jnp.zeros((0, 220, 220), jnp.float32),
        nd_dw=jnp.zeros((0, 66, 66), jnp.float32))
    wr, wi = jsplit.matvec_dense_pair(dev, p[7], p[8])
    np.testing.assert_allclose(_port(*arrays),
                               np.asarray(wr) + 1j * np.asarray(wi), **TOL)


def test_pair_shared_operator_batch():
    """An unbatched operator applied to a batch of vectors (the GF
    injection batch) equals the per-vector products."""
    rng = np.random.default_rng(9)
    diag, hdw, hup, _ = _rand_problem(rng, 12, 66)
    xs = _rand_problem(rng, 12, 66, b=4)[3]
    out = _port(diag, hdw, hup, xs)
    for i in range(4):
        np.testing.assert_allclose(out[i], _port(diag, hdw, hup, xs[i]),
                                   **TOL)


def test_pair_wrapper_rejects_what_the_kernel_cannot_take():
    rng = np.random.default_rng(1)
    diag, hdw, hup, x = (torch.from_numpy(a)
                         for a in _rand_problem(rng, 8, 12))
    with pytest.raises(TypeError):
        fused.fused_pair_matvec(diag, hdw, hup, x.to(torch.complex128))
    with pytest.raises(TypeError):
        fused.fused_pair_matvec(diag, hdw.real.contiguous(), hup, x)
    with pytest.raises(TypeError):
        fused.fused_pair_matvec(diag.to(torch.complex64), hdw, hup, x)
    with pytest.raises(ValueError):
        fused.fused_pair_matvec(diag, hup, hup, x)
    with pytest.raises(ValueError):
        fused.fused_pair_matvec(diag, hdw[None].repeat(2, 1, 1), hup, x)


def test_complex64_goes_through_the_wrapper(monkeypatch):
    """matvec_dense_pair sends every complex64 vector to the fused
    wrapper and keeps complex128 on the matmul path."""
    calls = []
    real = fused.fused_pair_matvec

    def spy(*args):
        calls.append(args[-1].dtype)
        return real(*args)

    monkeypatch.setattr(fused, "fused_pair_matvec", spy)
    rng = np.random.default_rng(2)
    diag, hdw, hup, x = (torch.from_numpy(a)
                         for a in _rand_problem(rng, 6, 4))
    op = tsplit.DenseComplexOp(diag=diag, hdw=hdw, hupT=hup,
                               nd_amp=torch.zeros(0, dtype=torch.complex64),
                               nd_upT=torch.zeros(0, 4, 4),
                               nd_dw=torch.zeros(0, 6, 6))
    out32 = tsplit.matvec_dense_pair(op, x)
    assert calls == [torch.complex64]
    op64 = tsplit.DenseComplexOp(
        diag=diag.double(), hdw=hdw.to(torch.complex128),
        hupT=hup.to(torch.complex128),
        nd_amp=torch.zeros(0, dtype=torch.complex128),
        nd_upT=torch.zeros(0, 4, 4, dtype=torch.float64),
        nd_dw=torch.zeros(0, 6, 6, dtype=torch.float64))
    out64 = tsplit.matvec_dense_pair(op64, x.to(torch.complex128))
    assert calls == [torch.complex64]
    np.testing.assert_allclose(out32.numpy(), out64.numpy(), **TOL)


# ---------------------------------------------------------------------------
# the pair operator of BHZ sectors
# ---------------------------------------------------------------------------

KEYS = ((3, 3), (2, 3), (3, 2))


@pytest.fixture(scope="module")
def ops():
    jcfg = jpkg.EDConfig(**bhz_case.KW)
    tcfg = tpkg.EDConfig(**dataclasses.asdict(jcfg))
    jops = bhz_case.sector_ops(jpkg, jcfg, KEYS)
    tops = bhz_case.sector_ops(tpkg, tcfg, KEYS)
    return {k: (jops[k], tops[k]) for k in KEYS}


def test_sectors_are_complex(ops):
    for jop, top in ops.values():
        assert not tsplit.op_is_real(top) and not jsplit.op_is_real(jop)
        np.testing.assert_array_equal(top.h_up.to_dense(),
                                      jop.h_up.to_dense())
        np.testing.assert_array_equal(top.h_dw.to_dense(),
                                      jop.h_dw.to_dense())
        # time reversal: the spin-down factor is the conjugate of the
        # spin-up one in the (nup, ndw) = (3, 3) sector
    jop, top = ops[(3, 3)]
    np.testing.assert_allclose(top.h_dw.to_dense(),
                               top.h_up.to_dense().conj(), atol=1e-15)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("pad", [None, (24, 32)])
def test_padded_pair_arrays_equal(ops, dtype, pad):
    """Port hdw.real is JAX hdw_r, hdw.imag is hdw_i, and so on; the
    +1e6 padding contract included."""
    jop, top = ops[(3, 3)]
    jdev = jsplit.to_device_dense_split(jop, pad_to=pad,
                                        dtype=getattr(jnp, dtype))
    tdev = tsplit.to_device_dense_split(top, pad_to=pad,
                                        dtype=getattr(torch, dtype))
    assert tdev.hdw.dtype == tsplit.complex_dtype(getattr(torch, dtype))

    def eq(t, j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    eq(tdev.diag, jdev.diag)
    eq(tdev.hdw.real, jdev.hdw_r)
    eq(tdev.hdw.imag, jdev.hdw_i)
    eq(tdev.hupT.real, jdev.hupT_r)
    eq(tdev.hupT.imag, jdev.hupT_i)
    if dtype == "float64":
        eq(tdev.hdw.real + tdev.hdw.imag, jdev.hdw_s)
        eq(tdev.hupT.real + tdev.hupT.imag, jdev.hupT_s)
    eq(tdev.nd_amp.real, jdev.nd_amp_r)
    eq(tdev.nd_amp.imag, jdev.nd_amp_i)
    eq(tdev.nd_upT, jdev.nd_upT)
    eq(tdev.nd_dw, jdev.nd_dw)


def test_stacked_pair_ops_equal(ops):
    pad = (20, 20)
    keys = ((3, 3), (2, 3))
    js = jsplit.stack_pair_ops([ops[k][0] for k in keys], pad)
    ts = tsplit.stack_pair_ops([ops[k][1] for k in keys], pad)
    for tf, jf in (("hdw", "hdw"), ("hupT", "hupT")):
        np.testing.assert_array_equal(getattr(ts, tf).real.numpy(),
                                      np.asarray(getattr(js, jf + "_r")))
        np.testing.assert_array_equal(getattr(ts, tf).imag.numpy(),
                                      np.asarray(getattr(js, jf + "_i")))
    np.testing.assert_array_equal(ts.diag.numpy(), np.asarray(js.diag))


def test_apply_pair_flat_f64(ops):
    jop, top = ops[(2, 3)]
    jkit = jsplit.build_pair_padded(jop)
    tkit = tsplit.build_pair_padded(top, device="cpu")
    assert jkit[1] is False and tkit[1] is False and jkit[2] == tkit[2]
    rng = np.random.default_rng(0)
    v = rng.normal(size=top.dim) + 1j * rng.normal(size=top.dim)
    ve = jkit[3](v)
    wr, wi = jsplit.apply_pair_flat(jkit[0], jnp.asarray(ve.real),
                                    jnp.asarray(ve.imag))
    ref = np.asarray(wr) + 1j * np.asarray(wi)
    te = tkit[3](v)
    assert te.dtype == np.complex128 and np.array_equal(te, ve)
    out = tsplit.apply_pair_flat(tkit[0], torch.from_numpy(te)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
    oracle = top.matvec_np(v)
    back = tkit[4](out)
    assert back.dtype == np.complex128
    np.testing.assert_allclose(back, oracle, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_apply_pair_flat_batched_f64(ops):
    pad = (20, 20)
    keys = ((3, 3), (2, 3))
    js = jsplit.stack_pair_ops([ops[k][0] for k in keys], pad)
    ts = tsplit.stack_pair_ops([ops[k][1] for k in keys], pad)
    rng = np.random.default_rng(1)
    x = np.stack([tsplit.embed_real(
        rng.normal(size=ops[k][1].dim) + 1j * rng.normal(
            size=ops[k][1].dim), ops[k][1].dim_dw, ops[k][1].dim_up, *pad)
        for k in keys])
    wr, wi = jsplit.apply_pair_flat_batched(js, jnp.asarray(x.real),
                                            jnp.asarray(x.imag))
    ref = np.asarray(wr) + 1j * np.asarray(wi)
    out = tsplit.apply_pair_flat_batched(ts, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
    # padding stays decoupled: zero in, zero out
    pad_rows = out[1].reshape(pad)[ops[(2, 3)][1].dim_dw:]
    assert not pad_rows.any()


# ---------------------------------------------------------------------------
# complex eigensolvers
# ---------------------------------------------------------------------------

NEIGEN, NCV, MAXITER, TOL_L = 2, 20, 2000, 1e-18


@pytest.fixture(scope="module")
def sector(ops):
    jop, top = ops[(3, 3)]
    jkit = jsplit.build_pair_padded(jop)
    tkit = tsplit.build_pair_padded(top, device="cpu")
    rng = np.random.default_rng(8527)
    v0 = jkit[3](rng.normal(size=top.dim) + 1j * rng.normal(size=top.dim))
    return jop, top, jkit, tkit, v0


def test_lanczos_eigh_split_f64(sector):
    jop, top, jkit, tkit, v0 = sector
    kw = dict(neigen=NEIGEN, ncv=NCV, maxiter=MAXITER, tol=TOL_L, v0=v0)
    jr = jl.lanczos_eigh_split(jsplit.apply_pair_flat, jkit[2], op=jkit[0],
                               **kw)
    tr = tl.lanczos_eigh_split(tsplit.apply_pair_flat, tkit[2], op=tkit[0],
                               **kw)
    np.testing.assert_allclose(tr.eigenvalues, np.asarray(jr.eigenvalues),
                               rtol=0, atol=1e-10)
    assert tr.converged and tr.eigenvectors.dtype == np.complex128
    # the ground vectors agree up to a phase
    ov = np.vdot(np.asarray(jr.eigenvectors)[0], tr.eigenvectors[0])
    assert abs(abs(ov) - 1.0) < 1e-8
    w0 = np.linalg.eigvalsh(top.to_dense())[:NEIGEN]
    np.testing.assert_allclose(tr.eigenvalues, w0, rtol=0, atol=1e-10)


def test_lanczos_eigh_mixed(sector):
    jop, top, jkit, tkit, v0 = sector
    j32 = jsplit.build_pair_padded(jop, dtype=jnp.float32)[0]
    t32 = tsplit.build_pair_padded(top, dtype=torch.float32,
                                   device="cpu")[0]
    kw = dict(neigen=NEIGEN, ncv=NCV, maxiter=MAXITER, tol=TOL_L, v0=v0)
    jr = jl.lanczos_eigh_mixed(jsplit.apply_pair_flat, jsplit.apply_pair_flat,
                               jkit[2], op32=j32, op64=jkit[0], **kw)
    tr = tl.lanczos_eigh_mixed(tsplit.apply_pair_flat,
                               tsplit.apply_pair_flat, tkit[2], op32=t32,
                               op64=tkit[0], **kw)
    np.testing.assert_allclose(tr.eigenvalues, np.asarray(jr.eigenvalues),
                               rtol=0, atol=1e-8)
    w0 = np.linalg.eigvalsh(top.to_dense())[:NEIGEN]
    np.testing.assert_allclose(tr.eigenvalues, w0, rtol=0, atol=1e-8)


@pytest.mark.parametrize("mixed", [False, True])
def test_batched_split_solvers(ops, mixed):
    keys = ((2, 3), (3, 2))              # dims 300, one bucket pad (20, 20)
    pad = (20, 20)
    rng = np.random.default_rng(8527)
    v0 = np.stack([jsplit.embed_real(
        rng.normal(size=ops[k][1].dim) + 1j * rng.normal(
            size=ops[k][1].dim), ops[k][1].dim_dw, ops[k][1].dim_up, *pad)
        for k in keys])
    kw = dict(neigen=NEIGEN, ncv=NCV, maxiter=MAXITER, tol=TOL_L, v0=v0)
    dim_p = pad[0] * pad[1]
    jops = [ops[k][0] for k in keys]
    tops = [ops[k][1] for k in keys]
    if mixed:
        jres = jl.lanczos_eigh_mixed_split_batched(
            jsplit.apply_pair_flat_batched, jsplit.apply_pair_flat_batched,
            2, dim_p, op32=jsplit.stack_pair_ops(jops, pad,
                                                 dtype=jnp.float32),
            op64=jsplit.stack_pair_ops(jops, pad), **kw)
        tres = tl.lanczos_eigh_mixed_split_batched(
            tsplit.apply_pair_flat_batched, tsplit.apply_pair_flat_batched,
            2, dim_p, op32=tsplit.stack_pair_ops(tops, pad,
                                                 dtype=torch.float32),
            op64=tsplit.stack_pair_ops(tops, pad), **kw)
        atol = 1e-8
    else:
        jres = jl.lanczos_eigh_split_batched(
            jsplit.apply_pair_flat_batched, 2, dim_p,
            op=jsplit.stack_pair_ops(jops, pad), **kw)
        tres = tl.lanczos_eigh_split_batched(
            tsplit.apply_pair_flat_batched, 2, dim_p,
            op=tsplit.stack_pair_ops(tops, pad), **kw)
        atol = 1e-10
    for jr, tr, top in zip(jres, tres, tops):
        np.testing.assert_allclose(tr.eigenvalues,
                                   np.asarray(jr.eigenvalues), rtol=0,
                                   atol=atol)
        w0 = np.linalg.eigvalsh(top.to_dense())[:NEIGEN]
        np.testing.assert_allclose(tr.eigenvalues, w0, rtol=0, atol=1e-8)


def test_lanczos_tridiag_batched_split(sector):
    jop, top, jkit, tkit, _ = sector
    rng = np.random.default_rng(4)
    v0 = np.stack([jkit[3](rng.normal(size=top.dim)
                           + 1j * rng.normal(size=top.dim))
                   for _ in range(3)])
    ja, jb, jn = jl.lanczos_tridiag_batched_split(
        jsplit.apply_pair_flat, v0, 32, op=jkit[0])
    ta, tb, tn = tl.lanczos_tridiag_batched_split(
        tsplit.apply_pair_flat, v0, 32, op=tkit[0])
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tn, jn, rtol=1e-14)
