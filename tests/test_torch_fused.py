"""The port's fused H·v wrapper (ops/fused.py) against the JAX package.

On the CPU the wrapper takes its plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode, as tests/test_pallas_fused.py does.
Tolerance 2e-4 (f32 sums in another order), as there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from cdmft_lanc_ed_tpu.ops import pallas_fused
from cdmft_lanc_ed_tpu.ops import split as jsplit
from cdmft_lanc_ed_torch.ops import fused
from cdmft_lanc_ed_torch.ops import split as tsplit


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


TOL = dict(rtol=2e-4, atol=2e-4)


def _rand_problem(rng, d, u, b=None):
    lead = () if b is None else (b,)
    diag = rng.normal(size=lead + (d, u)).astype(np.float32)
    hdw = rng.normal(size=lead + (d, d)).astype(np.float32)
    hup = rng.normal(size=lead + (u, u)).astype(np.float32)
    x = rng.normal(size=lead + (d, u)).astype(np.float32)
    return diag, hdw, hup, x


def _port(*arrays):
    return fused.fused_real_matvec(
        *(torch.from_numpy(a) for a in arrays)).numpy()


@pytest.mark.parametrize("d,u", [(128, 128), (256, 128), (128, 384)])
def test_fused_matches_pallas_interpret(d, u):
    rng = np.random.default_rng(7)
    diag, hdw, hup, x = _rand_problem(rng, d, u)
    launches0 = fused.launches
    ref = np.asarray(pallas_fused.fused_real_matvec(
        jnp.asarray(diag), jnp.asarray(hdw), jnp.asarray(hup),
        jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(_port(diag, hdw, hup, x), ref, **TOL)
    assert fused.launches == launches0      # CPU tensors never launch


def test_fused_batched_matches_vmap():
    """A batch of 3 sectors against the JAX vmap form (the batched
    solver's dispatch)."""
    rng = np.random.default_rng(3)
    arrays = _rand_problem(rng, 128, 256, b=3)
    fn = jax.vmap(lambda dg, a, c, v: pallas_fused.fused_real_matvec(
        dg, a, c, v, interpret=True))
    ref = np.asarray(fn(*(jnp.asarray(a) for a in arrays)))
    np.testing.assert_allclose(_port(*arrays), ref, **TOL)


def test_fused_ragged_matches_split():
    """A shape the 128-aligned Pallas kernel cannot take (tiny sectors
    reach the CUDA kernel unpadded) against JAX's split.matvec_dense_real
    in f32."""
    rng = np.random.default_rng(5)
    diag, hdw, hup, x = _rand_problem(rng, 66, 220)
    nd0 = jnp.zeros((0,), jnp.float32)
    dev = jsplit.DenseRealOp(
        diag=jnp.asarray(diag), hdw=jnp.asarray(hdw),
        hupT=jnp.asarray(hup), nd_amp=nd0,
        nd_upT=jnp.zeros((0, 220, 220), jnp.float32),
        nd_dw=jnp.zeros((0, 66, 66), jnp.float32))
    ref = np.asarray(jsplit.matvec_dense_real(dev, jnp.asarray(x)))
    np.testing.assert_allclose(_port(diag, hdw, hup, x), ref, **TOL)


def test_shared_operator_batch():
    """An unbatched operator applied to a batch of vectors (the GF
    injection batch) equals the per-vector products."""
    rng = np.random.default_rng(9)
    diag, hdw, hup, _ = _rand_problem(rng, 12, 66)
    xs = rng.normal(size=(4, 12, 66)).astype(np.float32)
    out = _port(diag, hdw, hup, xs)
    for i in range(4):
        np.testing.assert_allclose(out[i], _port(diag, hdw, hup, xs[i]),
                                   **TOL)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    rng = np.random.default_rng(1)
    diag, hdw, hup, x = (torch.from_numpy(a)
                         for a in _rand_problem(rng, 8, 12))
    with pytest.raises(TypeError):
        fused.fused_real_matvec(diag.double(), hdw, hup, x)
    with pytest.raises(ValueError):
        fused.fused_real_matvec(diag, hup, hup, x)
    with pytest.raises(ValueError):
        fused.fused_real_matvec(diag, hdw[None].repeat(2, 1, 1), hup, x)


def test_f32_plane_goes_through_the_wrapper(monkeypatch):
    """matvec_dense_real sends every f32 plane to the fused wrapper and
    keeps f64 planes on the matmul path."""
    calls = []
    real = fused.fused_real_matvec

    def spy(*args):
        calls.append(args[-1].shape)
        return real(*args)

    monkeypatch.setattr(fused, "fused_real_matvec", spy)
    rng = np.random.default_rng(2)
    diag, hdw, hup, x = (torch.from_numpy(a)
                         for a in _rand_problem(rng, 6, 4))
    op = tsplit.DenseRealOp(diag=diag, hdw=hdw, hupT=hup,
                            nd_amp=torch.zeros(0),
                            nd_upT=torch.zeros(0, 4, 4),
                            nd_dw=torch.zeros(0, 6, 6))
    out32 = tsplit.matvec_dense_real(op, x)
    assert len(calls) == 1
    op64 = tsplit.DenseRealOp(**{k: v.double() for k, v in vars(op).items()})
    out64 = tsplit.matvec_dense_real(op64, x.double())
    assert len(calls) == 1
    np.testing.assert_allclose(out32.numpy(), out64.numpy(), **TOL)
