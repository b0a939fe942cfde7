"""The port's large-sector kits (ops/large.py) against the JAX package.

Both packages get the same numpy-seeded inputs.  The JAX side runs as its
own tests run it on the CPU: its Pallas kernel is unreachable off the TPU,
so ``_blk_spmm_xla`` is the reference SpMM, and whole solves run its split
backend (CDMFT_SPLIT_BACKEND=1).

* Block factors: ``block_factor_of`` and ``block_factor_of_coo`` equal
  JAX's bit for bit, the padding tile of an empty output band included.
* Plain SpMM: ``blk_spmm_ref`` against ``_blk_spmm_xla`` in f64 (1e-12
  relative), f32 (2e-4 of the largest entry) and with bf16 tiles (both
  upcast the tiles to f32 on the CPU; 1e-5, summation order only).
* Matvecs: the real kit with and without Jx/Jp terms, the batched
  appliers (the batch folded into the SpMM width), the complex pair kit
  and a real H on complex vectors, all f64 to 1e-12.
* Coarse stage: the mixed solver with a bf16-tile first stage against
  JAX's on a sector forced onto the large kit (eigenvalues 1e-10).
* The Ns=16 flagship's bath: EDSolver at ``plaquette_replica_bath``
  builds ``__graft_entry__._plaquette_bath_op``'s operator exactly (at
  fewer baths).

Whole solves through the large kits are in tests/test_torch_large_solve.py
(the two files run in parallel under xdist; each takes under 30 s in one
process).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import __graft_entry__ as ge
import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_torch import kit
from cdmft_lanc_ed_tpu.ops import lanczos as jlanczos
from cdmft_lanc_ed_tpu.ops import large as jlarge
from cdmft_lanc_ed_tpu.ops import sector_ham as jsh
from cdmft_lanc_ed_torch.ops import lanczos as tlanczos
from cdmft_lanc_ed_torch.ops import large as tlarge
from cdmft_lanc_ed_torch.ops import sector_ham as tsh
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


def _hubbard_ops(nup, ndw, nbath=1, jh=0.0, complex_h=False):
    """The Ns=6 sector of tests/test_large_sector.py:17-36 built by both
    packages: (JAX op, port op)."""
    norb = 2 if jh else 1
    nlat = 2
    kw = dict(nlat=nlat, norb=norb, nspin=1, nbath=nbath,
              uloc=[2.0] * norb, ust=0.5 if jh else 0.0, jh=jh, jx=jh,
              jp=jh, ed_verbose=0)
    nn = (nlat, nlat, 1, 1, norb, norb)
    hloc = np.zeros(nn, np.complex128)
    for o in range(norb):
        hloc[0, 1, 0, 0, o, o] = -1.0 + (0.3j if complex_h else 0.0)
        hloc[1, 0, 0, 0, o, o] = np.conj(hloc[0, 1, 0, 0, o, o])
    hrec = np.zeros((nbath,) + nn, np.complex128)
    for b in range(nbath):
        for il in range(nlat):
            for o in range(norb):
                hrec[b, il, il, 0, 0, o, o] = -0.4 + 0.8 * b
    dhyb = np.full((nlat, 1, norb, nbath), 0.45)
    return (jsh.build_sector_operator(jpkg.EDConfig(**kw), hloc, hrec,
                                      dhyb, nup, ndw),
            tsh.build_sector_operator(tpkg.EDConfig(**kw), hloc, hrec,
                                      dhyb, nup, ndw))


def _same_factor(j, t):
    assert j.nb == t.nb and j.nnz == t.nnz
    for f in ("row_blk", "col_blk", "first", "tiles"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def _coo(seed=0, m=1100):
    """COO triplets of an m x m factor (m > 8·128: two output bands) whose
    rows all lie in the first band, with duplicates."""
    rng = np.random.default_rng(seed)
    k = 3000
    rows = rng.integers(0, 1000, size=k)
    cols = rng.integers(0, m, size=k)
    vals = rng.normal(size=k)
    return m, rows, cols, vals


def test_block_factors_match_jax():
    m, rows, cols, vals = _coo()
    for dtype in (np.float32, np.float64):
        j = jlarge.block_factor_of_coo(m, rows, cols, vals, True, dtype)
        t = tlarge.block_factor_of_coo(m, rows, cols, vals, True, dtype)
        _same_factor(j, t)
    # the second band has no entries: it owns one zero padding tile
    assert j.nb == 9 and int((t.row_blk // tlarge.SUP == 1).sum()) == 1
    assert not t.tiles[t.row_blk == 8].any()
    cvals = vals + 1j * np.roll(vals, 1)
    _same_factor(jlarge.block_factor_of_coo(m, rows, cols, cvals, False),
                 tlarge.block_factor_of_coo(m, rows, cols, cvals, False))
    for complex_h in (False, True):
        jop, top = _hubbard_ops(3, 2, nbath=2, complex_h=complex_h)
        for side in ("h_up", "h_dw"):
            _same_factor(
                jlarge.block_factor_of(getattr(jop, side), not complex_h),
                tlarge.block_factor_of(getattr(top, side), not complex_h))


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_plain_spmm_matches_jax(dtype):
    m, rows, cols, vals = _coo(1)
    f = tlarge.block_factor_of_coo(m, rows, cols, vals, True,
                                   np.float64 if dtype == "f64"
                                   else np.float32)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(f.nb * tlarge.B, 37))
    xdt = np.float64 if dtype == "f64" else np.float32
    ttiles = torch.as_tensor(f.tiles)
    jtiles = jnp.asarray(f.tiles)
    if dtype == "bf16":
        ttiles = ttiles.to(torch.bfloat16)
        jtiles = jtiles.astype(jnp.bfloat16)
    n0 = tlarge.launches
    y = tlarge.blk_spmm(torch.as_tensor(f.row_blk),
                        torch.as_tensor(f.col_blk), ttiles,
                        torch.as_tensor(x.astype(xdt)), f.nb).numpy()
    assert tlarge.launches == n0          # the CPU takes the plain version
    yj = np.asarray(jlarge._blk_spmm(
        jnp.asarray(f.row_blk), jnp.asarray(f.col_blk),
        jnp.asarray(f.first), jtiles, jnp.asarray(x.astype(xdt)), f.nb))
    assert y.dtype == yj.dtype == xdt
    scale = np.abs(yj).max()
    tol = {"f64": 1e-12, "f32": 2e-4, "bf16": 1e-5}[dtype]
    assert np.abs(y - yj).max() <= tol * scale


def _port_kit(top, dtype=torch.float64):
    """The port's tile kit of ``top``: the kit chooser with the
    dense-factor limit below its factors."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsplit, "DENSE_FACTOR_MAX", 0)
        return kit.kit_for(top, dtype, "cpu")


@pytest.mark.parametrize("jh", [0.0, 0.3])
def test_real_matvecs_match_jax(jh):
    jop, top = _hubbard_ops(2, 2, nbath=0 if jh else 2, jh=jh)
    assert bool(top.nd_terms) == bool(jh)
    jdev, dim_p, jembed, _ = jlarge.build_real_padded_large(
        jop, dtype=jnp.float64)
    tk = _port_kit(top)
    tdev, tembed, textract = tk.dev, tk.embed, tk.extract
    assert tk.real and tk.dim_p == dim_p
    assert np.array_equal(tdev.diag.numpy(), np.asarray(jdev.diag))
    rng = np.random.default_rng(3)
    v = rng.normal(size=(3, top.dim))
    xj = jnp.asarray(jembed(v))
    xt = tembed(torch.as_tensor(v))
    wj = np.asarray(jlarge.apply_large_real_flat(jdev, xj[0]))
    assert tk.apply is tlarge.apply_large_real_flat
    wt = tlarge.apply_large_real_flat(tdev, xt[0]).numpy()
    np.testing.assert_allclose(wt, wj, rtol=1e-12, atol=1e-12)
    # extraction keeps tensors tensors; the oracle on the unpadded vector
    np.testing.assert_allclose(
        textract(torch.as_tensor(wt)).numpy(),
        top.matvec_np(v[0].astype(np.complex128)).real, rtol=1e-12,
        atol=1e-12)
    wbj = np.asarray(jlarge.apply_large_real_flat_batched(jdev, xj))
    wbt = tlarge.apply_large_real_flat_batched(tdev, xt).numpy()
    np.testing.assert_allclose(wbt, wbj, rtol=1e-12, atol=1e-12)
    # a real H on complex vectors: both planes through the real tiles
    vi = rng.normal(size=(3, top.dim))
    xc = tembed(torch.as_tensor(v + 1j * vi))
    wc = tlarge.apply_large_real_flat_batched(tdev, xc).numpy()
    wr, wi = jlarge.apply_large_realpair_flat_batched(
        jdev, xj, jnp.asarray(jembed(vi)))
    np.testing.assert_allclose(wc, np.asarray(wr) + 1j * np.asarray(wi),
                               rtol=1e-12, atol=1e-12)


def test_pair_kit_matches_jax():
    jop, top = _hubbard_ops(2, 2, nbath=1, complex_h=True)
    assert not tsplit.op_is_real(top)
    jdev, jreal, dim_p, jembed, _ = jlarge.build_pair_padded_large(
        jop, dtype=jnp.float64)
    tk = _port_kit(top)
    tdev, tembed, textract = tk.dev, tk.embed, tk.extract
    assert not jreal and not tk.real and tk.dim_p == dim_p
    assert tdev.dw_tiles.dtype == torch.complex128
    rng = np.random.default_rng(4)
    vr, vi = rng.normal(size=(2, 3, top.dim))
    xr, xi = jnp.asarray(jembed(vr)), jnp.asarray(jembed(vi))
    xt = tembed(torch.as_tensor(vr + 1j * vi))
    sr, si = jlarge.apply_large_pair_flat(jdev, xr[0], xi[0])
    w = tlarge.apply_large_real_flat(tdev, xt[0]).numpy()
    np.testing.assert_allclose(w, np.asarray(sr) + 1j * np.asarray(si),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        textract(torch.as_tensor(w)).numpy(),
        top.matvec_np(vr[0] + 1j * vi[0]), rtol=1e-11, atol=1e-11)
    br, bi = jlarge.apply_large_pair_flat_batched(jdev, xr, xi)
    wb = tlarge.apply_large_real_flat_batched(tdev, xt).numpy()
    np.testing.assert_allclose(wb, np.asarray(br) + 1j * np.asarray(bi),
                               rtol=1e-12, atol=1e-12)


def test_coarse_stage_matches_jax():
    """bf16 tiles for the cold restarts, f32 below bf16 resolution, the
    f64 refine: both packages land on the same eigenvalues."""
    jop, top = _hubbard_ops(3, 3, nbath=2)
    w_ref = np.linalg.eigvalsh(top.to_dense())[:2]
    rng = np.random.default_rng(5)
    v0 = rng.normal(size=top.dim)
    j32, dim_p, jembed, _ = jlarge.build_real_padded_large(
        jop, dtype=jnp.float32)
    j16 = jlarge.build_real_padded_large(jop, dtype=jnp.bfloat16,
                                         reuse=j32)[0]
    j64 = jlarge.build_real_padded_large(jop, dtype=jnp.float64)[0]
    kw = dict(neigen=2, ncv=16, maxiter=800, tol=1e-12, vec_rtol=1e-10)
    jres = jlanczos.lanczos_eigh_mixed_real(
        jlarge.apply_large_real_flat, jlarge.apply_large_real_flat, dim_p,
        v0=jembed(v0), op32=j32, op64=j64, op16=j16, **kw)
    tk = _port_kit(top, torch.float32)
    t16 = tk.coarse()
    assert t16.dw_tiles.dtype == torch.bfloat16 and t16.diag is tk.dev.diag
    tres = tlanczos.eigh_mixed(
        tk.apply, tk.apply, tk.dim_p, v0=tk.embed(v0), op32=tk.dev,
        op16=t16, op64=lambda: _port_kit(top).dev, **kw)
    np.testing.assert_allclose(tres.eigenvalues, jres.eigenvalues,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tres.eigenvalues, w_ref, rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("nbath,nup,ndw", [(1, 4, 4), (2, 5, 6)])
def test_flagship_bath_builds_the_graft_entry_operator(tmp_path, nbath, nup,
                                                       ndw):
    """EDSolver at ``plaquette_replica_bath`` builds the sector operator of
    the JAX package's ``__graft_entry__._plaquette_bath_op`` (at nbath=3
    the Ns=16 flagship of the card's smoke run) exactly."""
    from cdmft_lanc_ed_torch.bath import DmftBath, pack_dmft_bath
    from cdmft_lanc_ed_torch.models.hubbard import plaquette_replica_bath
    hloc, basis, lam, v = plaquette_replica_bath(nbath)
    cfg = tpkg.EDConfig(nlat=4, norb=1, nspin=1, nbath=nbath, uloc=[4.0],
                        ed_verbose=0, work_dir=str(tmp_path))
    s = tpkg.EDSolver(cfg, device="cpu")
    s.set_hbath(basis, lam)
    s.init_solver()
    s.bath = tpkg.unpack_dmft_bath(cfg, pack_dmft_bath(
        cfg, DmftBath(v=v, lam=lam)))
    s.imp_hloc = hloc
    top = s._sector_builder()(nup, ndw)
    jop = ge._plaquette_bath_op(nbath, nup, ndw)[1]
    assert np.array_equal(top.diag(), jop.diag())
    for side in ("h_up", "h_dw"):
        assert np.array_equal(getattr(top, side).to_dense(),
                              getattr(jop, side).to_dense())
    assert not top.nd_terms and not jop.nd_terms

