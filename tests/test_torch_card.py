"""The CUDA kernels of the port on the card: each builds from csrc/,
launches (counted) and agrees with its plain version.  Skips without
CUDA.

This file imports no JAX, so it also runs where JAX is missing:

    python -m pytest tests/test_torch_card.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from cdmft_lanc_ed_torch.ops import fused, large, split


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    return torch.device("cuda")


def tf32_round(a):
    """``a`` (float32 or complex64) with every float rounded to TF32's
    10-bit mantissa, to nearest (chip_smoke.py's control)."""
    f = torch.view_as_real(a) if a.is_complex() else a
    i = f.contiguous().view(torch.int32)
    r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.view_as_complex(r) if a.is_complex() else r


@pytest.mark.cuda
@pytest.mark.parametrize("b,shared", [(0, False), (1, False), (3, False),
                                      (9, False), (1, True), (3, True),
                                      (9, True)])
@pytest.mark.parametrize("d,u", [(1, 1), (12, 66), (924, 924),
                                 (1024, 1024)])
def test_kernel_matches_plain(card, b, d, u, shared):
    """The real kernel at the unbucketed (1, 12x66) and bucketed shapes,
    unbatched and at B = 1, 3, 9, with per-member or shared (batch stride
    0) operators: 2e-4 of the largest entry, and a tenth of the error
    that TF32-rounded inputs give (IEEE f32, never TF32)."""
    rng = np.random.default_rng(11)
    lead = (b,) if b and not shared else ()
    xlead = (b,) if b else ()

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=card)

    args = (t(*lead, d, u), t(*lead, d, d), t(*lead, u, u), t(*xlead, d, u))
    n0, s0 = fused.launches, fused.real_shapes[(b or 1, d, u)]
    out = fused.fused_real_matvec(*args)
    torch.cuda.synchronize()
    assert fused.launches == n0 + 1
    assert fused.real_shapes[(b or 1, d, u)] == s0 + 1
    ref = fused.fused_real_matvec_ref(*args)
    err = float((out - ref).abs().max())
    tf32 = float((fused.fused_real_matvec_ref(*map(tf32_round, args))
                  - ref).abs().max())
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert err <= 2e-4 * float(ref.abs().max())
    assert err <= 0.1 * tf32


@pytest.mark.cuda
def test_shared_operator_and_f32_dispatch(card):
    rng = np.random.default_rng(12)
    d, u = 70, 56
    op = split.DenseRealOp(
        diag=torch.as_tensor(rng.normal(size=(d, u)), device=card),
        hdw=torch.as_tensor(rng.normal(size=(d, d)), device=card),
        hupT=torch.as_tensor(rng.normal(size=(u, u)), device=card),
        nd_amp=torch.zeros(0, device=card, dtype=torch.float64),
        nd_upT=torch.zeros(0, u, u, device=card, dtype=torch.float64),
        nd_dw=torch.zeros(0, d, d, device=card, dtype=torch.float64))
    op32 = split.DenseRealOp(**{k: v.float() for k, v in vars(op).items()})
    x = torch.as_tensor(rng.normal(size=(5, d * u)), device=card)
    n0 = fused.launches
    y32 = split.apply_real_flat(op32, x.float())
    assert fused.launches == n0 + 1
    y64 = split.apply_real_flat(op, x)
    assert fused.launches == n0 + 1
    assert float((y32.double() - y64).abs().max()) \
        <= 2e-4 * float(y64.abs().max())


def _check_pair(card, seed, b, d, u, shared, offset=0):
    """The complex kernel against its plain version on seeded inputs: the
    JAX package's bound for its complex Pallas kernel (1e-3 of the largest
    entry), and a tenth of the error that TF32-rounded inputs give (IEEE
    f32, never TF32).  ``offset``: x lies that many elements into a larger
    buffer."""
    rng = np.random.default_rng(seed)
    lead = (b,) if b and not shared else ()
    xlead = (b,) if b else ()

    def c(*shape):
        a = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return torch.as_tensor(a.astype(np.complex64), device=card)

    diag = torch.as_tensor(rng.normal(size=lead + (d, u)).astype(
        np.float32), device=card)
    hdw, hupT, x = c(*lead, d, d), c(*lead, u, u), c(*xlead, d, u)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=card)
        x = buf[offset:].view(x.shape).copy_(x)
    args = (diag, hdw, hupT, x)
    n0 = fused.pair_launches
    out = fused.fused_pair_matvec(*args)
    torch.cuda.synchronize()
    assert fused.pair_launches == n0 + 1
    ref = fused.fused_pair_matvec_ref(*args)
    err = float((out - ref).abs().max())
    tf32 = float((fused.fused_pair_matvec_ref(*map(tf32_round, args))
                  - ref).abs().max())
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert err <= 1e-3 * float(ref.abs().max())
    assert err <= 0.1 * tf32


@pytest.mark.cuda
@pytest.mark.parametrize("b,shared", [(0, False), (1, False), (3, False),
                                      (9, False), (1, True), (3, True),
                                      (9, True)])
@pytest.mark.parametrize("d,u", [(1, 1), (12, 66), (7, 33), (66, 220),
                                 (256, 256), (924, 924), (1024, 1024)])
def test_pair_kernel_matches_plain(card, b, d, u, shared):
    """The complex kernel at the unbucketed (1, 12x66, 66x220: the cluster
    pair, 66x220 over two row tiles, the second ragged), odd-U (7x33: one
    complex value per copy) and bucketed shapes (256² below B = 9: the
    cluster pair over four row tiles), unbatched and at B = 1, 3, 9, with
    per-member or shared (batch stride 0) operators."""
    _check_pair(card, 13, b, d, u, shared)


@pytest.mark.cuda
def test_pair_kernel_misaligned_x(card):
    """x one element into a larger buffer, so not 16-byte aligned: the
    kernel copies one complex value at a time and agrees as well."""
    _check_pair(card, 15, 3, 924, 924, False, offset=1)


@pytest.mark.cuda
def test_complex64_dispatch(card):
    """complex64 vectors take the complex kernel, complex128 the matmuls;
    the two agree."""
    rng = np.random.default_rng(14)
    d, u = 70, 56

    def c(*shape):
        return torch.as_tensor(rng.normal(size=shape)
                               + 1j * rng.normal(size=shape), device=card)

    op = split.DenseComplexOp(
        diag=torch.as_tensor(rng.normal(size=(d, u)), device=card),
        hdw=c(d, d), hupT=c(u, u),
        nd_amp=torch.zeros(0, device=card, dtype=torch.complex128),
        nd_upT=torch.zeros(0, u, u, device=card, dtype=torch.float64),
        nd_dw=torch.zeros(0, d, d, device=card, dtype=torch.float64))
    op32 = split.DenseComplexOp(
        diag=op.diag.float(), hdw=op.hdw.to(torch.complex64),
        hupT=op.hupT.to(torch.complex64),
        nd_amp=op.nd_amp.to(torch.complex64), nd_upT=op.nd_upT.float(),
        nd_dw=op.nd_dw.float())
    x = c(5, d * u)
    n0 = fused.pair_launches
    y32 = split.apply_pair_flat(op32, x.to(torch.complex64))
    assert fused.pair_launches == n0 + 1
    y64 = split.apply_pair_flat(op, x)
    assert fused.pair_launches == n0 + 1
    assert float((y32.to(torch.complex128) - y64).abs().max()) \
        <= 1e-3 * float(y64.abs().max())


# tolerance of each block-sparse instantiation against its plain version,
# relative to the largest entry (chip_smoke.py's large_kernel phase)
BLK_TOL = {"f32": 2e-4, "bf16": 1e-5, "f64": 1e-12, "c64": 2e-4,
           "c128": 1e-12}


def _blk_factor(seed, m, complex_, empty_band):
    """A random m x m block factor (~1% full) in the kernel's layout; row 5
    holds 40 nonzeros, more than one warp's load of 32.  With
    ``empty_band`` the rows of the second output band stay empty (it owns
    only its zero padding tile) while the bands on either side of it hold
    nonzeros."""
    rng = np.random.default_rng(seed)
    k = m * 4
    band = 8 * large.B
    if empty_band:
        rows = rng.choice(np.r_[0:min(band, m), 2 * band:m], size=k)
    else:
        rows = rng.integers(0, m, size=k)
    rows = np.concatenate([rows, np.full(40, 5)])
    cols = np.concatenate([rng.integers(0, m, size=k),
                           rng.choice(m, size=40, replace=False)])
    vals = rng.normal(size=k + 40)
    if complex_:
        vals = vals + 1j * rng.normal(size=k + 40)
    return large.block_factor_of_coo(m, rows, cols, vals, not complex_,
                                     np.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(BLK_TOL))
@pytest.mark.parametrize("m,n,empty_band", [(2100, 512, False),
                                            (1100, 77, True),
                                            (2100, 77, True),
                                            (2100, 1536, True),
                                            (2100, 1536, False)])
def test_blk_spmm_matches_plain(card, kind, m, n, empty_band):
    """Every instantiation on factors with a row longer than 32 nonzeros,
    with nonzeros in every band or an empty band between two full ones, at
    a ragged n (77: one element per access) and at n = 512 and 1536
    (16-byte accesses).  A column slice of the grid is 512 f32, 1024 bf16,
    256 f64 or complex64 and 128 complex128 columns wide, so at n = 1536
    every row crosses two or more slices in every type (at 512: f64 and
    the complex types).  Held to the plain version on the same inputs
    (bf16: the plain version in f32 on the bf16 inputs); f32 and
    complex64 also within a tenth of the TF32 control."""
    cplx = kind in ("c64", "c128")
    f = _blk_factor(21, m, cplx, empty_band)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f64": torch.float64, "c64": torch.complex64,
          "c128": torch.complex128}[kind]
    rng = np.random.default_rng(22)
    x = rng.normal(size=(f.nb * large.B, n))
    if cplx:
        x = x + 1j * rng.normal(size=x.shape)
    tiles = torch.as_tensor(f.tiles, device=card).to(dt)
    xt = torch.as_tensor(x, device=card).to(
        torch.float32 if kind == "bf16" else dt)
    rb, cb = (torch.as_tensor(a, device=card)
              for a in (f.row_blk, f.col_blk))
    n0 = large.launches
    y = large.blk_spmm(rb, cb, tiles, xt, f.nb)
    torch.cuda.synchronize()
    assert large.launches == n0 + 1
    if kind == "bf16":
        ref = large.blk_spmm_ref(rb, cb, tiles.float(),
                                 xt.to(torch.bfloat16).float(), f.nb)
    else:
        ref = large.blk_spmm_ref(rb, cb, tiles, xt, f.nb)
    assert y.dtype == ref.dtype and y.shape == ref.shape
    assert bool(torch.isfinite(y).all())
    if empty_band:
        assert not bool(y[8 * large.B:16 * large.B].any())
        assert bool(y[:8 * large.B].any())
        if m > 16 * large.B:
            assert bool(y[16 * large.B:m].any())
    err = float((y - ref).abs().max())
    assert err <= BLK_TOL[kind] * float(ref.abs().max())
    if kind in ("f32", "c64"):
        tf32 = float((large.blk_spmm_ref(rb, cb, tf32_round(tiles),
                                         tf32_round(xt), f.nb)
                      - ref).abs().max())
        assert err <= 0.1 * tf32


@pytest.mark.cuda
def test_large_matvec_on_card(card, monkeypatch):
    """The large kit's f32 matvec launches the kernel twice (one per
    side) and agrees with its f64 matvec."""
    from cdmft_lanc_ed_torch import EDConfig, kit
    from cdmft_lanc_ed_torch.models.hubbard import plaquette_replica_bath
    from cdmft_lanc_ed_torch.ops import sector_ham
    hloc, basis, lam, v = plaquette_replica_bath(1)
    cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=1, uloc=[4.0])
    hrec = lam[:, 0, None, None, None, None, None, None] * basis
    dhyb = v.T.reshape(4, 1, 1, -1)
    op = sector_ham.build_sector_operator(cfg, hloc, hrec, dhyb, 4, 4)
    monkeypatch.setattr(split, "DENSE_FACTOR_MAX", 0)   # the tile kit
    k32 = kit.kit_for(op, torch.float32, card)
    d32, d64 = k32.dev, kit.kit_for(op, torch.float64, card).dev
    assert k32.apply is large.apply_large_real_flat
    x = k32.embed(torch.as_tensor(np.random.default_rng(23).normal(
        size=op.dim), device=card))
    n0 = large.launches
    y32 = large.apply_large_real_flat(d32, x.float())
    assert large.launches == n0 + 2
    y64 = large.apply_large_real_flat(d64, x)
    assert float((y32.double() - y64).abs().max()) \
        <= 2e-4 * float(y64.abs().max())



@pytest.mark.cuda
@pytest.mark.parametrize("d,u", [(128, 56), (128, 128), (56, 128)])
@pytest.mark.parametrize("batched", [False, True])
def test_realpair_on_card(card, d, u, batched):
    """A real operator on complex64 vectors (the 4-channel GF of a real
    problem; the smoke's realpair_gf phase launches (56, 128, 56)): both
    planes of 28 vectors in one real-kernel launch of B=56 (a batched
    operator: one launch per plane), against the f64 product within the
    real kernel's bound."""
    rng = np.random.default_rng(41)
    nv = 28
    lead = (nv,) if batched else ()

    def r(*shape):
        return torch.as_tensor(rng.normal(size=lead + shape), device=card)

    op = split.DenseRealOp(
        diag=r(d, u), hdw=r(d, d), hupT=r(u, u),
        nd_amp=torch.zeros(lead + (0,), device=card, dtype=torch.float64),
        nd_upT=torch.zeros(lead + (0, u, u), device=card,
                           dtype=torch.float64),
        nd_dw=torch.zeros(lead + (0, d, d), device=card,
                          dtype=torch.float64))
    op32 = split.DenseRealOp(**{k: getattr(op, k).float() for k in (
        "diag", "hdw", "hupT", "nd_amp", "nd_upT", "nd_dw")})
    x = torch.as_tensor(rng.normal(size=(nv, d * u))
                        + 1j * rng.normal(size=(nv, d * u)), device=card)
    n0, s0 = fused.launches, fused.real_shapes[(2 * nv, d, u)]
    y32 = split.apply_realpair_flat(op32, x.to(torch.complex64))
    torch.cuda.synchronize()
    if batched:
        assert fused.launches == n0 + 2
    else:
        assert fused.launches == n0 + 1
        assert fused.real_shapes[(2 * nv, d, u)] == s0 + 1
    y64 = split.apply_realpair_flat(op, x)
    assert fused.launches == n0 + (2 if batched else 1)
    assert float((y32.to(torch.complex128) - y64).abs().max()) \
        <= 2e-4 * float(y64.abs().max())


@pytest.mark.cuda
def test_pair_kernel_at_the_edge_cluster_batch(card):
    """The edge loop's cluster (one BHZ layer, Nx=2, 2 replica baths:
    Ns=12) in its half-filled (6,6) sector, 924x924 factors in the 1024
    bucket, stacked nine deep as the batched Krylov stage stacks
    same-bucket sectors: one pair-kernel launch of (9, 1024, 1024) against
    the complex128 product within the pair kernel's bound."""
    from cdmft_lanc_ed_torch import EDConfig, bath
    from cdmft_lanc_ed_torch.models import bhz
    from cdmft_lanc_ed_torch.ops import sector_ham
    model = dict(mh=1.0, ts=0.25, lam=0.3)
    cfg = EDConfig(nlat=2, norb=2, nspin=2, nbath=2, uloc=[2.0, 2.0],
                   ust=0.5, ed_verbose=0)
    basis, lam0 = bhz.bhz_bath_basis(2, 1, **model)
    hb = bath.set_hbath(basis, np.tile(lam0, (2, 1)), cfg)
    b = bath.init_dmft_bath(cfg, hb)
    op = sector_ham.build_sector_operator(
        cfg, bhz.bhz_cluster_hloc(2, 1, **model), bath.bath_h_rec(cfg, hb, b),
        bath.diag_hybr_of(cfg, b), 6, 6)
    assert not split.op_is_real(op) and (op.dim_dw, op.dim_up) == (924, 924)
    ops = [op] * 9
    st32 = split.stack_pair_ops(ops, (1024, 1024), dtype=torch.float32,
                                device=card)
    st64 = split.stack_pair_ops(ops, (1024, 1024), device=card)
    rng = np.random.default_rng(43)
    x = torch.as_tensor(rng.normal(size=(9, 1024 * 1024))
                        + 1j * rng.normal(size=(9, 1024 * 1024)),
                        device=card)
    n0, s0 = fused.pair_launches, fused.pair_shapes[(9, 1024, 1024)]
    y32 = split.apply_pair_flat(st32, x.to(torch.complex64))
    torch.cuda.synchronize()
    assert fused.pair_launches == n0 + 1
    assert fused.pair_shapes[(9, 1024, 1024)] == s0 + 1
    y64 = split.apply_pair_flat(st64, x)
    assert float((y32.to(torch.complex128) - y64).abs().max()) \
        <= 1e-3 * float(y64.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,empty_band", [(2100, 512, False),
                                            (1100, 77, True),
                                            (2100, 77, True),
                                            (2100, 1536, True),
                                            (2100, 514, False)])
def test_blk_spmm_bf16c_matches_plain(card, m, n, empty_band):
    """The bf16 complex instantiation ([T, 128, 128, 2] bf16 (re, im)
    tiles, complex64 x cast to bf16 pairs, complex64 y) on the factors of
    test_blk_spmm_matches_plain, at a ragged n (77, 514: one element per
    access) and at 512 and 1536 (16-byte accesses, 4 pairs each).  Held to
    the plain version on the same bf16 inputs (only the order of the f32
    sums differs: 1e-5), and to the complex64 product of the unrounded
    inputs within the bf16 bound 2^-7·(|A|·|x|)."""
    f = _blk_factor(31, m, True, empty_band)
    rng = np.random.default_rng(32)
    x = rng.normal(size=(f.nb * large.B, n)) \
        + 1j * rng.normal(size=(f.nb * large.B, n))
    tiles = torch.view_as_real(torch.as_tensor(f.tiles, device=card)).to(
        torch.bfloat16)
    xt = torch.as_tensor(x, device=card).to(torch.complex64)
    rb, cb = (torch.as_tensor(a, device=card)
              for a in (f.row_blk, f.col_blk))
    n0 = large.launches_by.get("blk_spmm_bf16c", 0)
    y = large.blk_spmm(rb, cb, tiles, xt, f.nb)
    torch.cuda.synchronize()
    assert large.launches_by["blk_spmm_bf16c"] == n0 + 1
    ref = large.blk_spmm_ref(rb, cb, tiles, xt, f.nb)
    assert y.dtype == ref.dtype == torch.complex64
    assert bool(torch.isfinite(y).all())
    if empty_band:
        assert not bool(y[8 * large.B:16 * large.B].any())
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    t64 = torch.as_tensor(f.tiles, device=card).to(torch.complex64)
    y64 = large.blk_spmm_ref(rb, cb, t64, xt, f.nb)
    bound = 2.0 ** -7 * large.blk_spmm_ref(
        rb, cb, t64.real.abs() + t64.imag.abs(),
        xt.real.abs() + xt.imag.abs(), f.nb)
    assert bool(((y - y64).abs() <= bound + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("complex_h", [False, True])
def test_sharded_large_one_rank_nccl(card, tmp_path, monkeypatch,
                                    complex_h):
    """parallel.sharded_large on a (1, 1) mesh over NCCL (real
    all-to-alls over one rank): the one-vector and batched appliers
    launch the kernel and agree with the large kit's f64 appliers."""
    import torch.distributed as dist
    from cdmft_lanc_ed_torch import EDConfig, kit
    from cdmft_lanc_ed_torch.ops import sector_ham
    from cdmft_lanc_ed_torch.parallel import (distributed, multichip,
                                              sharded_large)
    nn = (2, 2, 1, 1, 2, 2)
    hloc = np.zeros(nn, np.complex128)
    for o in range(2):
        hloc[0, 1, 0, 0, o, o] = -1.0 + (0.3j if complex_h else 0.0)
        hloc[1, 0, 0, 0, o, o] = np.conj(hloc[0, 1, 0, 0, o, o])
    hrec = np.zeros((1,) + nn, np.complex128)
    hrec[0, 0, 0, 0, 0, 0, 0] = hrec[0, 1, 1, 0, 0, 1, 1] = -0.4
    cfg = EDConfig(nlat=2, norb=2, nspin=1, nbath=1, uloc=[2.0, 2.0],
                   ust=0.5, jh=0.3, jx=0.3, jp=0.3)
    op = sector_ham.build_sector_operator(cfg, hloc, hrec,
                                          np.full((2, 1, 2, 1), 0.45), 3, 3)
    assert op.nd_terms
    mesh = distributed.init_distributed(
        store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        assert dist.get_backend() == "nccl"
        monkeypatch.setattr(split, "DENSE_FACTOR_MAX", 0)
        ref = kit.kit_for(op, torch.float64, card, fold=True)
        multichip.set_solver_mesh(mesh)
        sk = kit.kit_for(op, torch.float64, card, shard_from=0)
        dev, embed, extract = sk.dev, sk.embed, sk.extract
        assert isinstance(dev, sharded_large.ShardedLargeRealOp)
        assert sk.real == (not complex_h) and sk.dim_p == ref.dim_p
        rng = np.random.default_rng(33)
        v = rng.normal(size=(3, op.dim))
        if complex_h:
            v = v + 1j * rng.normal(size=v.shape)
        vt = torch.as_tensor(v, device=card)
        n0 = large.launches
        y1 = extract(sharded_large.apply_sharded_large_real_flat(
            dev, embed(vt[0])))
        yb = extract(sharded_large.apply_sharded_large_real_flat_batched(
            dev, embed(vt)))
        torch.cuda.synchronize()
        assert large.launches == n0 + 4
        want = ref.extract(ref.apply(ref.dev, ref.embed(vt)))
        scale = float(want.abs().max())
        assert float((y1 - want[0]).abs().max()) <= 1e-12 * scale
        assert float((yb - want).abs().max()) <= 1e-12 * scale
    finally:
        multichip.set_solver_mesh(None)
        dist.destroy_process_group()
