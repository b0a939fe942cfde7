"""The compact form of a block-sparse factor (ops/large.py), the operand of
the CUDA kernel ``csrc/blk_spmm.cu``, against the tiles and the JAX
package.

The kernel itself runs only on the card (tests/test_torch_card.py); here
the same factor goes through a plain product over its compact form, the
port's plain version ``blk_spmm_ref`` and the JAX package's
``_blk_spmm_xla``, on numpy-seeded inputs: a factor whose second output
band is empty, at a ragged width n = 37, in f64 (1e-12 relative), f32
(2e-4 of the largest entry), bf16 tiles (1e-5, summation order only:
both sides upcast the tiles to f32) and complex128 (1e-12), the bounds
of ``test_plain_spmm_matches_jax``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from cdmft_lanc_ed_tpu.ops import large as jlarge
from cdmft_lanc_ed_torch.ops import large as tlarge

TOL = {"f64": 1e-12, "f32": 2e-4, "bf16": 1e-5, "c128": 1e-12}
TORCH = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16,
         "c128": torch.complex128}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One BLAS and one intra-op thread (the suite runs in several worker
    processes at once)."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(nthreads)


def _factor(kind, seed=5, m=1100):
    """An m x m factor (two output bands, the second empty) with
    duplicates, in the tile type of ``kind``; a row with 40 nonzeros."""
    rng = np.random.default_rng(seed)
    k = 3000
    rows = np.concatenate([rng.integers(0, 1000, size=k), np.full(40, 7)])
    cols = np.concatenate([rng.integers(0, m, size=k),
                           rng.choice(m, size=40, replace=False)])
    vals = rng.normal(size=k + 40)
    if kind == "c128":
        vals = vals + 1j * rng.normal(size=k + 40)
    return tlarge.block_factor_of_coo(
        m, rows, cols, vals, kind != "c128",
        np.float64 if kind in ("f64", "c128") else np.float32)


def _torch_factor(f, kind):
    return (torch.as_tensor(f.row_blk), torch.as_tensor(f.col_blk),
            torch.as_tensor(f.tiles).to(TORCH[kind]))


def _dense_tiles(f, tiles):
    nb = f.nb * tlarge.B
    d = torch.zeros(nb, nb, dtype=tiles.dtype)
    for t in range(len(f.row_blk)):
        r, c = int(f.row_blk[t]) * tlarge.B, int(f.col_blk[t]) * tlarge.B
        d[r:r + tlarge.B, c:c + tlarge.B] += tiles[t]
    return d


def _dense_compact(index, n_rows):
    row_ptr, cols, vals = index
    rows = torch.repeat_interleave(torch.arange(n_rows),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    d = torch.zeros(n_rows, n_rows, dtype=vals.dtype)
    d[rows, cols.long()] = vals
    return d


def _compact_product(index, x):
    """Plain product over the compact form: y[r] = Σ_p vals[p]·x[cols[p]]
    (bf16 values widened to f32)."""
    row_ptr, cols, vals = index
    if vals.dtype == torch.bfloat16:
        vals = vals.float()
    rows = torch.repeat_interleave(torch.arange(len(row_ptr) - 1),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    y = torch.zeros(len(row_ptr) - 1, x.shape[1], dtype=x.dtype)
    return y.index_add_(0, rows, vals[:, None] * x[cols.long()])


@pytest.mark.parametrize("kind", list(TOL))
def test_compact_form_densifies_to_the_tiles(kind):
    f = _factor(kind)
    rb, cb, tiles = _torch_factor(f, kind)
    index = tlarge.blk_compact(tiles, tlarge.blk_structure(rb, cb, tiles,
                                                           f.nb))
    row_ptr, cols, vals = index
    assert row_ptr.dtype == cols.dtype == torch.int32
    assert vals.dtype == tiles.dtype
    assert len(vals) == len(cols) == int((tiles != 0).sum())
    assert torch.equal(_dense_compact(index, f.nb * tlarge.B),
                       _dense_tiles(f, tiles))
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    assert not bool(counts[8 * tlarge.B:].any())      # the empty band
    assert int(counts[7]) >= 40
    for r in range(f.nb * tlarge.B):                   # ascending columns
        c = cols[row_ptr[r]:row_ptr[r + 1]]
        assert bool((c[1:] > c[:-1]).all())


@pytest.mark.parametrize("kind", list(TOL))
def test_compact_product_matches_plain_and_jax(kind):
    f = _factor(kind)
    rb, cb, tiles = _torch_factor(f, kind)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(f.nb * tlarge.B, 37))
    if kind == "c128":
        x = x + 1j * rng.normal(size=x.shape)
    xdt = np.float64 if kind in ("f64", "c128") else np.float32
    x = x.astype(np.complex128 if kind == "c128" else xdt)
    index = tlarge.blk_compact(tiles, tlarge.blk_structure(rb, cb, tiles,
                                                           f.nb))
    y = _compact_product(index, torch.as_tensor(x)).numpy()
    ref = tlarge.blk_spmm_ref(rb, cb, tiles, torch.as_tensor(x),
                              f.nb).numpy()
    jtiles = jnp.asarray(f.tiles)
    if kind == "bf16":
        jtiles = jtiles.astype(jnp.bfloat16).astype(jnp.float32)
    yj = np.asarray(jlarge._blk_spmm_xla(
        jnp.asarray(f.row_blk), jnp.asarray(f.col_blk), jtiles,
        jnp.asarray(x), f.nb))
    assert y.dtype == ref.dtype == yj.dtype
    scale = np.abs(yj).max()
    assert np.abs(y - ref).max() <= TOL[kind] * scale
    assert np.abs(y - yj).max() <= TOL[kind] * scale
    assert not y[8 * tlarge.B:].any()


def test_reuse_shares_one_structure():
    """Under ``reuse`` the bf16 and f64 operators of a sector share the
    f32 operator's nonzero structure; their values follow their tiles."""
    from cdmft_lanc_ed_torch import EDConfig
    from cdmft_lanc_ed_torch.models.hubbard import plaquette_replica_bath
    from cdmft_lanc_ed_torch.ops import sector_ham
    hloc, basis, lam, v = plaquette_replica_bath(1)
    cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=1, uloc=[4.0])
    hrec = lam[:, 0, None, None, None, None, None, None] * basis
    dhyb = v.T.reshape(4, 1, 1, -1)
    op = sector_ham.build_sector_operator(cfg, hloc, hrec, dhyb, 4, 4)
    d32 = tlarge.to_device_large_real(op, dtype=torch.float32,
                                      device="cpu")
    for dt in (torch.bfloat16, torch.float64):
        d = tlarge.to_device_large_real(op, dtype=dt, reuse=d32,
                                        device="cpu")
        for side in ("dw", "up"):
            nz, nz32 = getattr(d, f"{side}_nz"), getattr(d32, f"{side}_nz")
            assert all(a is b for a, b in zip(nz, nz32))
            row_ptr, cols, vals = getattr(d, f"{side}_idx")
            assert row_ptr is nz32[0] and cols is nz32[1]
            assert vals.dtype == dt
            assert torch.equal(vals, getattr(d, f"{side}_tiles")
                               .reshape(-1)[nz32[2]])
            assert torch.equal(vals.double(),
                               getattr(d32, f"{side}_idx")[2].to(dt)
                               .double())
