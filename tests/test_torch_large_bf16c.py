"""The complex coarse stage of large mixed solves: bf16 complex tiles.

The port stores a complex factor's bf16 tiles as a real bf16 tensor
[T, 128, 128, 2] of (re, im) pairs (torch has no complex bf16), and its
plain SpMM multiplies bf16-rounded tiles and bf16-rounded x in complex64.
The JAX package rounds three Karatsuba planes (re, im, re+im) instead and,
on the CPU, keeps x in f32.  The two round differently, so each is held
to the f64 product within the bf16 bound

    |y - y64| <= 2^-7 · (|H_off| @ |x|) + 2^-20 · |diag| |x| + 1e-12

elementwise, with |z| = |re z| + |im z|: 2^-7 is four bf16 unit
roundoffs (u = 2^-9): one for the tile, one for x, two for the
re+im plane of the Karatsuba form.  The whole complex mixed large solve
with the coarse stage is held to the JAX package's (egs 1e-9, Sigma
2e-5 relative) on the complex Ns=6 case of tests/bhz_case.py, its sweep
cut to one sector with ``split.DENSE_FACTOR_MAX`` lowered in both
packages, as tests/test_torch_large_solve.py does.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import bhz_case
import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_torch import kit
from cdmft_lanc_ed_tpu.models import bhz as jbhz
from cdmft_lanc_ed_tpu.ops import large as jlarge
from cdmft_lanc_ed_tpu.ops import split as jsplit
from cdmft_lanc_ed_torch.carry import state_from_numpy
from cdmft_lanc_ed_torch.models import bhz as tbhz
from cdmft_lanc_ed_torch.ops import lanczos as tlanczos
from cdmft_lanc_ed_torch.ops import large as tlarge
from cdmft_lanc_ed_torch.ops import split as tsplit

BF16_REL = 2.0 ** -7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One BLAS and one intra-op thread (several test workers share the
    cores)."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(nthreads)


def _l1(z):
    return np.abs(z.real) + np.abs(z.imag)


def _ops(key=(3, 3)):
    """The (3,3) sector of the complex Ns=6 case in both packages."""
    cfg_j = jpkg.EDConfig(**bhz_case.KW)
    cfg_t = tpkg.EDConfig(**bhz_case.KW)
    return (bhz_case.sector_ops(jpkg, cfg_j, [key])[key],
            bhz_case.sector_ops(tpkg, cfg_t, [key])[key])


def _bound(op, v):
    """The elementwise bf16 bound of the module docstring for H·v."""
    h = op.to_dense()
    d = np.diag(h).real
    off = _l1(h - np.diag(np.diag(h)))
    return BF16_REL * (off @ _l1(v)) + 2.0 ** -20 * np.abs(d) * _l1(v) \
        + 1e-12


def test_bf16c_tiles_and_plain_spmm():
    """Layout, compact form and plain SpMM of the bf16 complex tiles."""
    _, top = _ops()
    dev32 = tlarge.to_device_large_pair(top, dtype=torch.float32,
                                        device="cpu")
    dev16 = tlarge.to_device_large_pair(top, dtype=torch.bfloat16,
                                        reuse=dev32, device="cpu")
    t = dev16.dw_tiles
    assert t.dtype == torch.bfloat16 and t.shape[1:] == (128, 128, 2)
    assert tlarge.is_bf16c(t) and not tlarge.is_bf16c(dev32.dw_tiles)
    assert dev16.diag is dev32.diag and dev16.dw_nz is dev32.dw_nz
    assert dev16.nd_amp.dtype == torch.complex64
    # the tiles are the complex128 tiles rounded once to bf16 pairs
    f = tlarge.block_factor_of(top.h_dw, real=False)
    want = torch.view_as_real(torch.as_tensor(f.tiles)).to(torch.bfloat16)
    assert torch.equal(t, want)
    # the compact values are the nonzero pairs, in the structure's order
    row_ptr, cols, vals = dev16.dw_idx
    assert vals.shape == (cols.numel(), 2)
    assert torch.equal(vals, t.reshape(-1, 2)[dev32.dw_nz[2]])
    # plain SpMM: complex products of bf16 inputs, complex64 accumulation
    rng = np.random.default_rng(11)
    m = f.nb * 128
    x = (rng.normal(size=(m, 5)) + 1j * rng.normal(size=(m, 5)))
    xt = torch.as_tensor(x).to(torch.complex64)
    y = tlarge.blk_spmm(dev16.dw_rb, dev16.dw_cb, t, xt, f.nb)
    assert y.dtype == torch.complex64
    xb = torch.view_as_complex(torch.view_as_real(xt).to(torch.bfloat16)
                               .to(torch.float64))
    tb = torch.view_as_complex(t.to(torch.float64))
    exact = tlarge.blk_spmm_ref(dev16.dw_rb, dev16.dw_cb, tb, xb, f.nb)
    # the products of bf16 inputs are exact in f32: only the f32 sums err
    assert (y - exact).abs().max() <= 1e-6 * exact.abs().max()
    with pytest.raises(TypeError):
        tlarge.blk_spmm(dev16.dw_rb, dev16.dw_cb, t, xt.real.contiguous(),
                        f.nb)


def test_bf16c_matvec_within_the_bf16_bound_as_jax(monkeypatch):
    """The port's bf16 complex matvec and the JAX package's bf16 pair kit
    both lie within the bf16 bound of the f64 product (they round
    differently, so they are not held to each other)."""
    jop, top = _ops()
    j32 = jlarge.build_pair_padded_large(jop, dtype=jnp.float32)[0]
    jdev, jreal, dim_p, jembed, jextract = jlarge.build_pair_padded_large(
        jop, dtype=jnp.bfloat16, reuse=j32)
    monkeypatch.setattr(tsplit, "DENSE_FACTOR_MAX", 15)
    tk = kit.kit_for(top, torch.float32, "cpu")     # the f32 tile kit
    tdev, tembed, textract = tk.coarse(), tk.embed, tk.extract
    assert not jreal and not tk.real and tk.dim_p == dim_p
    rng = np.random.default_rng(12)
    v = rng.normal(size=top.dim) + 1j * rng.normal(size=top.dim)
    exact = top.matvec_np(v)
    bound = _bound(top, v)
    wr, wi = jlarge.apply_large_pair_flat(
        jdev, jnp.asarray(jembed(v.real), jnp.float32),
        jnp.asarray(jembed(v.imag), jnp.float32))
    wj = jextract(np.asarray(wr) + 1j * np.asarray(wi))
    wt = textract(tlarge.apply_large_real_flat(
        tdev, tembed(torch.as_tensor(v).to(torch.complex64)))).numpy()
    assert np.all(np.abs(wj - exact) <= bound)
    assert np.all(np.abs(wt - exact) <= bound)
    # and the bound is not slack: bf16 rounding shows at ~2^-9
    assert np.abs(wt - exact).max() > 1e-5 * np.abs(exact).max()
    # the batched applier folds the rows into the same SpMM
    vb = torch.as_tensor(np.stack([v, v.conj()])).to(torch.complex64)
    wb = textract(tlarge.apply_large_real_flat_batched(tdev, tembed(vb)))
    assert np.all(np.abs(wb[0].numpy() - exact) <= bound)


def _restricted(workdir, sector):
    workdir.mkdir(exist_ok=True)
    (workdir / "sectors_list.restart").write_text(f" {sector}\n")
    return str(workdir)


def _bhz_mixed_solve(pkg, workdir, jbath=None):
    """The complex Ns=6 case in mixed precision, restricted to its (3,3)
    sector; the port takes JAX's bath array through
    carry.state_from_numpy."""
    kw = dict(bhz_case.KW, ed_precision="mixed", ed_sectors=True,
              ed_sectors_shift=0, work_dir=_restricted(workdir, "3 3"))
    if pkg is jpkg:
        _, basis, lams = bhz_case.model(jbhz)
        s = jpkg.EDSolver(jpkg.EDConfig(**kw))
        s.set_hbath(basis, lams)
        bath = s.init_solver()
        s.solve(bath, bhz_case.lattice(jbhz)[1])
        return s, bath
    _, basis, lams = bhz_case.model(tbhz)
    cfg, hb, bath = state_from_numpy(
        dataclasses.asdict(jpkg.EDConfig(**kw)), basis, lams, jbath,
        device="cpu")
    s = tpkg.EDSolver(cfg, device="cpu")
    s.hb = hb
    s.init_solver()
    s.solve(bath, bhz_case.lattice(tbhz)[1])
    return s


def test_complex_mixed_large_solve_runs_the_coarse_stage(tmp_path,
                                                         monkeypatch):
    """A whole complex mixed solve on the large kits: the port passes
    bf16 complex tiles as ``op16``, the coarse stage hands over to the
    complex64 stage, and the result matches the JAX package's own mixed
    solve with its bf16 stage (egs 1e-9, Sigma 2e-5 relative)."""
    monkeypatch.setenv("CDMFT_SPLIT_BACKEND", "1")
    monkeypatch.setattr(jsplit, "DENSE_FACTOR_MAX", 15)
    monkeypatch.setattr(tsplit, "DENSE_FACTOR_MAX", 15)
    passed, applied = [], []
    mixed = tlanczos.eigh_mixed
    apply1 = tlarge.apply_large_real_flat

    def spy_mixed(*a, **kw):
        passed.append(kw.get("op16"))
        return mixed(*a, **kw)

    def spy_apply(op, x):
        applied.append("bf16c" if tlarge.is_bf16c(op.dw_tiles)
                       else str(op.dw_tiles.dtype))
        return apply1(op, x)

    monkeypatch.setattr(tlanczos, "eigh_mixed", spy_mixed)
    monkeypatch.setattr(tlarge, "apply_large_real_flat", spy_apply)
    j, jbath = _bhz_mixed_solve(jpkg, tmp_path / "jax")
    t = _bhz_mixed_solve(tpkg, tmp_path / "port", jbath)
    assert len(passed) == 1 and passed[0] is not None
    assert tlarge.is_bf16c(passed[0].dw_tiles)
    # coarse restarts first, then the complex64 stage, then the refine
    first = {k: applied.index(k) for k in set(applied)}
    assert set(first) == {"bf16c", "torch.complex64", "torch.complex128"}
    last_bf16c = len(applied) - 1 - applied[::-1].index("bf16c")
    assert last_bf16c < first["torch.complex64"] < \
        first["torch.complex128"]
    assert abs(t.egs - j.egs) <= 1e-9 * abs(j.egs)
    for name in ("gimp_matsubara", "sigma_matsubara"):
        a, b = getattr(t, name)(), np.asarray(getattr(j, name)())
        assert np.abs(a - b).max() <= 2e-5 * np.abs(b).max(), name
    np.testing.assert_allclose(t.dens(), np.asarray(j.dens()), atol=1e-7)
