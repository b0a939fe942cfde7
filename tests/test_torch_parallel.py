"""The port's sharded matvecs on gloo against the JAX package's on a mesh
of the same size.

The port's side runs at world sizes 2 and 4 in processes spawned with
torch.multiprocessing (``torch_dist_case.matvecs``); the JAX side runs in
this process on a ("dw",) mesh of as many of the 8 virtual CPU devices
that tests/conftest.py provides, on the same seeded inputs.  These mirror
tests/test_large_sector.py:319-440 (the sharded block-sparse matvecs,
with and without Jx/Jp, and the batched appliers) and
tests/test_sharded_spmv.py:36-110,155-185 (the dense-factor sharded
matvecs, ``overlap`` 0 and 2).  Tolerance: 1e-12 of the largest entry in
f64 and complex128, 1e-5 in f32 and complex64.  The eigensolvers over
the sharded vectors (every reduction summed over the "dw" group) are held
to the dense eigenvalues (1e-8), and a GF chain to the same chain on the
single-process large kit (1e-10).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
import torch_dist_case as case
from cdmft_lanc_ed_tpu.parallel import sharded_large as jsl
from cdmft_lanc_ed_tpu.parallel import sharded_spmv as jss
from cdmft_lanc_ed_torch import kit
from cdmft_lanc_ed_torch.ops import lanczos as tlanczos
from cdmft_lanc_ed_torch.ops import large as tlarge
from cdmft_lanc_ed_torch.ops import split as tsplit

WORLDS = [2, 4]


@pytest.fixture(scope="module", params=WORLDS)
def world(request, tmp_path_factory):
    """(world size, rank 0's results, every rank's results, JAX mesh)."""
    n = request.param
    out = case.run("matvecs", n, tmp_path_factory.mktemp(f"w{n}"))
    return n, out[0], out, Mesh(np.array(jax.devices()[:n]), ("dw",))


def _close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("name,kw,cplx,dt,seed", case.LARGE_CASES,
                         ids=[c[0] for c in case.LARGE_CASES])
def test_sharded_large_matvec_matches_jax(world, name, kw, cplx, dt, seed):
    _, got, _, mesh = world
    op = case.hubbard_op(jpkg, **kw)
    jdt = getattr(jnp, dt)
    v = case.vector(op.dim, cplx, seed)
    if cplx:
        mv = jsl.sharded_matvec_large_pair_flat(op, mesh, dtype=jdt)
        wr, wi = mv(jnp.asarray(v.real, jdt), jnp.asarray(v.imag, jdt))
        want = np.asarray(wr) + 1j * np.asarray(wi)
    else:
        mv = jsl.sharded_matvec_large_real_flat(op, mesh, dtype=jdt)
        want = np.asarray(mv(jnp.asarray(v, jdt)))
    tol = 1e-12 if dt == "float64" else 1e-5
    _close(got[name], want, tol)
    # and the oracle
    exact = op.matvec_np(v.astype(np.complex128))
    _close(got[name], exact if cplx else exact.real, tol)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "pair"])
def test_sharded_batched_appliers_match_jax(world, cplx):
    """The batched appliers (the batch folded into the SpMM width) against
    the JAX package's and against the one-vector appliers."""
    _, got, _, mesh = world
    name = "batched_pair" if cplx else "batched_real"
    op = case.hubbard_op(jpkg, 2, 2, nbath=1, jh=0.3, complex_h=cplx)
    x = case.vector(op.dim, cplx, 20, rows=3)
    if cplx:
        o = jsl.build_sharded_large_pair(op, mesh, dtype=jnp.float64)
        wr, wi = jax.jit(jsl.apply_sharded_large_pair_flat_batched)(
            o, jnp.asarray(x.real), jnp.asarray(x.imag))
        want = np.asarray(wr) + 1j * np.asarray(wi)
    else:
        o = jsl.build_sharded_large_real(op, mesh, dtype=jnp.float64)
        apply_b = jax.jit(jsl.apply_sharded_large_real_flat_batched)
        want = np.asarray(apply_b(o, jnp.asarray(x)))
    _close(got[name], want, 1e-12)
    _close(got[name], got[name + "_single"], 1e-13)


@pytest.mark.parametrize("overlap", [0, 2])
def test_sharded_dense_real_matches_jax(world, overlap):
    _, got, _, mesh = world
    op = case.spmv_op(jpkg, realify=True)
    v = case.vector(op.dim, False, 11)
    mv = jss.sharded_matvec_real_flat(op, mesh, overlap=overlap)
    _close(got[f"spmv_real_overlap{overlap}"],
           np.asarray(mv(jnp.asarray(v))), 1e-12)


def test_sharded_dense_jxjp_matches_jax(world):
    _, got, _, mesh = world
    op = case.real_spmv_op(jpkg)
    mv = jss.sharded_matvec_real_flat(op, mesh)
    _close(got["spmv_real_jxjp"],
           np.asarray(mv(jnp.asarray(case.vector(op.dim, False, 5)))),
           1e-12)
    op = case.spmv_op(jpkg, norb=2, nlat=1, nbath=3, nup=3, ndw=2, jx=0.25,
                      jp=0.15)
    v = case.vector(op.dim, True, 12)
    wr, wi = jss.sharded_matvec_pair_flat(op, mesh)(jnp.asarray(v.real),
                                                    jnp.asarray(v.imag))
    _close(got["spmv_pair_jxjp"], np.asarray(wr) + 1j * np.asarray(wi),
           1e-12)


def test_sharded_eigensolvers_and_chains(world, monkeypatch):
    """Mixed complex and f64 real thick-restart solves over the sharded
    vectors reach the dense eigenvalues; a GF chain over them is the
    single-process chain; every rank ends with the same numbers."""
    n, got, every, _ = world
    op = case.hubbard_op(tpkg, 2, 2, nbath=1, complex_h=True)
    np.testing.assert_allclose(got["mixed_pair_eigs"],
                               np.linalg.eigvalsh(op.to_dense())[:2],
                               rtol=1e-8, atol=1e-8)
    assert got["mixed_pair_resid"] < 1e-8
    op = case.hubbard_op(tpkg, 3, 3, nbath=2)
    np.testing.assert_allclose(got["real_eig"],
                               np.linalg.eigvalsh(op.to_dense())[:1],
                               rtol=1e-9, atol=1e-9)
    monkeypatch.setattr(tsplit, "DENSE_FACTOR_MAX", 0)   # the tile kit
    k = kit.kit_for(op, torch.float64, "cpu", fold=True)
    assert k.apply is tlarge.apply_large_real_flat_batched
    ref = tlanczos.tridiag(
        k.apply, k.embed(torch.as_tensor(case.vector(op.dim, False, 16,
                                                     rows=2))), 12,
        op=k.dev)
    for a, b in zip(got["tridiag"], ref):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)
    for other in every[1:]:
        np.testing.assert_array_equal(other["real_eig"], got["real_eig"])
        for a, b in zip(other["tridiag"], got["tridiag"]):
            np.testing.assert_array_equal(a, b)
    assert got["exchange_bytes"] > 0
