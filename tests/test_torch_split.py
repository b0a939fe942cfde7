"""The port's host sector layer and real dense-factor kit against the JAX
package: the same sector operator, the same padded device arrays (exactly),
and the same f64 H·v (to 1e-12 relative)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import __graft_entry__ as ge
from cdmft_lanc_ed_tpu.ops import split as jsplit
from cdmft_lanc_ed_torch import EDConfig, kit
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


FIELDS = ("diag", "hdw", "hupT", "nd_amp", "nd_upT", "nd_dw")


def _port_op(jcfg, nbath, nup, ndw):
    """The port's operator from the inputs of ge._plaquette_bath_op."""
    cfg = EDConfig(**dataclasses.asdict(jcfg))
    nn = (4, 4, 1, 1, 1, 1)
    hloc = np.zeros(nn, np.complex128)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        hloc[i, j, 0, 0, 0, 0] = hloc[j, i, 0, 0, 0, 0] = -1.0
    hrec = np.zeros((nbath,) + nn, np.complex128)
    for b in range(nbath):
        lam = -1.0 + 2.0 * b / max(nbath - 1, 1)
        for il in range(4):
            hrec[b, il, il, 0, 0, 0, 0] = lam
    dhyb = np.full((4, 1, 1, nbath), 0.5)
    return tsh.build_sector_operator(cfg, hloc, hrec, dhyb, nup, ndw)


@pytest.fixture(scope="module")
def ops():
    out = {}
    for nup, ndw in ((3, 4), (3, 8)):
        jcfg, jop = ge._plaquette_bath_op(nbath=2, nup=nup, ndw=ndw)
        out[(nup, ndw)] = (jop, _port_op(jcfg, 2, nup, ndw))
    return out


def test_sector_operator_matches(ops):
    jop, top = ops[(3, 4)]
    for name in ("aup", "adw", "w_updw", "n_up", "n_dw", "states_up",
                 "states_dw"):
        np.testing.assert_array_equal(getattr(top, name), getattr(jop, name))
    assert top.diag_const == jop.diag_const
    np.testing.assert_array_equal(top.h_up.to_dense(), jop.h_up.to_dense())
    np.testing.assert_array_equal(top.h_dw.to_dense(), jop.h_dw.to_dense())
    assert tsplit.op_is_real(top) and jsplit.op_is_real(jop)


@pytest.mark.parametrize("n", [1, 12, 64, 65, 66, 220, 495, 924, 8192, 9000])
def test_bucket_ladder(n):
    assert tsplit._bucket(n) == jsplit._bucket(n)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_padded_arrays_equal(ops, dtype):
    jop, top = ops[(3, 4)]
    pad = (jsplit._bucket(top.dim_dw), jsplit._bucket(top.dim_up))
    jdev = jsplit.to_device_dense_real(jop, pad_to=pad,
                                       dtype=getattr(jnp, dtype))
    tdev = tsplit.to_device_dense_real(top, pad_to=pad,
                                       dtype=getattr(torch, dtype),
                                       device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tdev, f).numpy(),
                                      np.asarray(getattr(jdev, f)))


def test_stacked_arrays_equal(ops):
    pad = (512, 256)
    js = jsplit.stack_real_ops([ops[k][0] for k in ((3, 4), (3, 8))], pad)
    ts = tsplit.stack_real_ops([ops[k][1] for k in ((3, 4), (3, 8))], pad,
                               device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))


def test_apply_real_flat_f64(ops):
    jop, top = ops[(3, 4)]
    jkit = jsplit.build_real_padded(jop)
    tkit = kit.kit_for(top, torch.float64, "cpu")
    assert jkit[1] == tkit.dim_p and tkit.apply is tsplit.apply_real_flat
    rng = np.random.default_rng(0)
    v = rng.normal(size=top.dim)
    ref = np.asarray(jsplit.apply_real_flat(jkit[0],
                                            jnp.asarray(jkit[2](v))))
    out = tsplit.apply_real_flat(tkit.dev, torch.from_numpy(tkit.embed(v)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
    # padding stays decoupled: zero in, zero out
    out2 = out.numpy().reshape(tkit.dev.diag.shape)
    assert not out2[top.dim_dw:].any() and not out2[:, top.dim_up:].any()
    oracle = top.matvec_np(v.astype(complex)).real
    np.testing.assert_allclose(tkit.extract(out.numpy()), oracle, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_apply_real_flat_batched_f64(ops):
    pad = (512, 256)
    keys = ((3, 4), (3, 8))
    js = jsplit.stack_real_ops([ops[k][0] for k in keys], pad)
    ts = tsplit.stack_real_ops([ops[k][1] for k in keys], pad,
                               device="cpu")
    rng = np.random.default_rng(1)
    x = np.stack([tsplit.embed_real(rng.normal(size=ops[k][1].dim),
                                    ops[k][1].dim_dw, ops[k][1].dim_up,
                                    *pad) for k in keys])
    ref = np.asarray(jsplit.apply_real_flat_batched(js, jnp.asarray(x)))
    out = tsplit.apply_real_flat(ts, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
