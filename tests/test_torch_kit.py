"""The kit chooser (``cdmft_lanc_ed_torch/kit.py``): each row of its
decision table gives the operator type and applier it names, and the
kit's H·v, between its ``embed`` and ``extract``, is ``op.to_dense() @ v``
to 1e-12.

Sectors of the 2-site Hubbard model of ``torch_dist_case.hubbard_op``
(Ns=6 and Ns=8, with Jx/Jp terms in one case); the tile kits by lowering
``split.DENSE_FACTOR_MAX`` below the spin factors, the sharded tile kit
on a one-rank gloo mesh in this process.
"""
import numpy as np
import pytest
import threadpoolctl
import torch
import torch.distributed as dist

import cdmft_lanc_ed_torch as tpkg
import torch_dist_case as case
from cdmft_lanc_ed_torch import kit
from cdmft_lanc_ed_torch.ops import large, split
from cdmft_lanc_ed_torch.parallel import (distributed, multichip,
                                          sharded_large)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One BLAS and one intra-op thread (several test workers share the
    cores)."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(nthreads)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A ("sector", "dw") mesh of one gloo rank."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("kit") / "store"), 1)
    m = distributed.init_distributed(device="cpu", store=store, rank=0,
                                     world_size=1)
    yield m
    multichip.set_solver_mesh(None)
    dist.destroy_process_group()


REAL = dict(nup=2, ndw=1, nbath=2)                  # Ns=6, dim 90
COMPLEX = dict(REAL, complex_h=True)
JXJP = dict(nup=2, ndw=2, nbath=1, jh=0.3)          # Ns=8, dim 784

# (id, sector, complex vectors, lowered DENSE_FACTOR_MAX, mesh installed,
#  shard_from, fold, operator type, applier)
CASES = [
    ("dense_real", REAL, False, None, False, None, False,
     split.DenseRealOp, split.apply_real_flat),
    ("dense_real_jxjp", JXJP, False, None, False, None, False,
     split.DenseRealOp, split.apply_real_flat),
    ("dense_realpair", REAL, True, None, False, None, False,
     split.DenseRealOp, split.apply_realpair_flat),
    ("dense_complex", COMPLEX, False, None, False, None, False,
     split.DenseComplexOp, split.apply_pair_flat),
    ("dense_complex_vectors", COMPLEX, True, None, False, None, False,
     split.DenseComplexOp, split.apply_pair_flat),
    ("large_real", REAL, False, 5, False, None, False,
     large.LargeRealOp, large.apply_large_real_flat),
    ("large_real_fold", JXJP, False, 5, False, None, True,
     large.LargeRealOp, large.apply_large_real_flat_batched),
    ("large_realpair_fold", REAL, True, 5, False, None, True,
     large.LargeRealOp, large.apply_large_real_flat_batched),
    ("large_complex", COMPLEX, False, 5, False, None, False,
     large.LargePairOp, large.apply_large_real_flat),
    ("mesh_below_shard_from", REAL, False, None, True, 91, False,
     split.DenseRealOp, split.apply_real_flat),
    ("mesh_without_shard_from", REAL, False, 5, True, None, False,
     large.LargeRealOp, large.apply_large_real_flat),
    ("sharded_real", REAL, False, None, True, 90, False,
     sharded_large.ShardedLargeRealOp,
     sharded_large.apply_sharded_large_real_flat),
    ("sharded_complex_fold", COMPLEX, False, 5, True, 0, True,
     sharded_large.ShardedLargePairOp,
     sharded_large.apply_sharded_large_real_flat_batched),
    ("sharded_realpair_jxjp", JXJP, True, None, True, 0, False,
     sharded_large.ShardedLargeRealOp,
     sharded_large.apply_sharded_large_real_flat),
]


@pytest.mark.parametrize(
    "sector,cplx,dense_max,on_mesh,shard_from,fold,kind,applier",
    [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_kit_choice_and_matvec(request, monkeypatch, sector, cplx,
                               dense_max, on_mesh, shard_from, fold, kind,
                               applier):
    if dense_max is not None:
        monkeypatch.setattr(split, "DENSE_FACTOR_MAX", dense_max)
    if on_mesh:
        multichip.set_solver_mesh(request.getfixturevalue("mesh"))
    try:
        op = case.hubbard_op(tpkg, **sector)
        k = kit.kit_for(op, torch.float64, "cpu", complex_vectors=cplx,
                        shard_from=shard_from, fold=fold)
    finally:
        multichip.set_solver_mesh(None)
    assert type(k.dev) is kind and k.apply is applier
    real = split.op_is_real(op)
    assert k.real == real
    assert k.vectors == (torch.float64 if real and not cplx
                         else torch.complex128)
    assert (k.coarse is not None) == (kind in (large.LargeRealOp,
                                               large.LargePairOp))
    rng = np.random.default_rng(7)
    v = rng.normal(size=(2, op.dim))
    if k.vectors.is_complex:
        v = v + 1j * rng.normal(size=v.shape)
    x = k.embed(torch.as_tensor(v).to(k.vectors))
    assert x.shape == (2, k.dim_p)
    hv = k.extract(k.apply(k.dev, x)).numpy()
    want = v @ op.to_dense().T
    np.testing.assert_allclose(hv, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_stacked_batch_kit():
    """Two sectors stacked in one padded shape: the stacked applier gives
    each member's H·v."""
    ops = [case.hubbard_op(tpkg, 2, 1, nbath=2),      # [DimDw, DimUp]
           case.hubbard_op(tpkg, 1, 2, nbath=2)]      # (6, 15), (15, 6)
    bucket = (15, 15)
    dev = kit.stacked(ops, bucket, True, torch.float64, "cpu")
    assert kit.stacked_apply(True) is split.apply_real_flat
    assert kit.stacked_apply(False) is split.apply_pair_flat
    rng = np.random.default_rng(8)
    vs = [rng.normal(size=o.dim) for o in ops]
    x = torch.as_tensor(np.stack([split.embed_real(
        v, o.dim_dw, o.dim_up, *bucket) for v, o in zip(vs, ops)]))
    y = kit.stacked_apply(True)(dev, x).numpy()
    for i, (v, o) in enumerate(zip(vs, ops)):
        hv = split.extract_real(y[i], o.dim_dw, o.dim_up, *bucket)
        want = o.to_dense().real @ v
        np.testing.assert_allclose(hv, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


def test_eigensolve_shard_rule():
    """diag's rule: shard from 64·lanc_dim_threshold, only on a mesh with
    a "dw" axis; the large-sector test reads the dense-factor limit."""
    cfg = tpkg.EDConfig(nlat=2, nbath=1, lanc_dim_threshold=4)
    assert kit.eig_shard_from(cfg) == 256
    assert not kit.sharded(10 ** 6, kit.eig_shard_from(cfg))    # no mesh
    assert kit.large_sector(16, 8, 8) and not kit.large_sector(14, 7, 7)
