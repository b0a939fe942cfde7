"""A real sector operator on complex vectors: ``split.apply_realpair_flat``
and the GF route that takes it, against the JAX package.

* The applier: a random real symmetric sector operator (with Jx/Jp terms)
  on seeded complex vectors, against the JAX package's
  ``apply_realpair_flat`` to 1e-13 (f64); the batched form against the
  unbatched one; the kit chooser gives a real operator for it.
* The 4-channel GF on a real problem (tests/test_real_fastpath.py:150-178:
  a 2-site cluster with two replica baths, Ns=6, the 2-channel scheme
  disabled): G(iw) and Sigma(iw) against the JAX package's (its split kit,
  CDMFT_SPLIT_BACKEND=1) on the same forced case to 1e-10, and against the
  2-channel GF to the JAX test's bounds (G 1e-8, Sigma 1e-6 absolute).
* The trigger of the smoke's ``realpair_gf`` phase: the same problem with
  one more bath-basis element, i (c+_0 c_1 - h.c.), at zero weight.  Hloc
  and every sector operator stay real, the complex basis sends the GF to
  the 4-channel scheme, so every complex injection takes the real
  operator's planes: the same bounds against the 2-channel problem
  without the element and 1e-10 against the JAX package; realpair
  applications counted, and none of the pair kit.  In single precision
  (``ed_gf_precision="single"``) G(iw) within 1e-5 of the 2-channel
  single-precision G (tests/test_torch_bhz.py's complex64 G bound).
"""
import numpy as np
import pytest
import threadpoolctl
import torch

import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
import cdmft_lanc_ed_tpu.gf as jgf
import cdmft_lanc_ed_torch.gf as tgf
from cdmft_lanc_ed_torch import kit
from cdmft_lanc_ed_tpu.ops import sector_ham as jsh
from cdmft_lanc_ed_tpu.ops import split as jsplit
from cdmft_lanc_ed_torch.ops import sector_ham as tsh
from cdmft_lanc_ed_torch.ops import split as tsplit


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One BLAS and one intra-op thread: the suite runs in several worker
    processes at once."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(nthreads)


def _real_op(pkg, sh):
    """tests/test_real_fastpath.py:15-28: a random REAL symmetric
    cluster+bath sector operator with Jx/Jp terms, in package ``pkg``."""
    cfg = pkg.EDConfig(nlat=1, norb=2, nspin=1, nbath=2,
                       uloc=[3.0, 2.0, 0, 0, 0], ust=0.5, jh=0.1, jx=0.2,
                       jp=0.1, ed_verbose=0)
    rng = np.random.default_rng(11)
    nn = (1, 1, 1, 1, 2, 2)
    h = rng.normal(size=nn).astype(complex)
    h = 0.5 * (h + h.conj().transpose(1, 0, 3, 2, 5, 4))
    hrec = (rng.normal(size=(2,) + nn) * 0.4).astype(complex)
    hrec = 0.5 * (hrec + hrec.conj().transpose(0, 2, 1, 4, 3, 6, 5))
    dhyb = rng.normal(size=(1, 1, 2, 2))
    return sh.build_sector_operator(cfg, h, hrec, dhyb, 3, 2)


def test_apply_realpair_flat_matches_jax():
    jop, top = _real_op(jpkg, jsh), _real_op(tpkg, tsh)
    jkit = jsplit.build_pair_padded(jop)
    tkit = kit.kit_for(top, torch.float64, "cpu", complex_vectors=True)
    assert jkit[1] is True and tkit.real is True and jkit[2] == tkit.dim_p
    assert isinstance(tkit.dev, tsplit.DenseRealOp)
    assert tkit.apply is tsplit.apply_realpair_flat
    assert tkit.vectors == torch.complex128
    rng = np.random.default_rng(5)
    v = rng.normal(size=(3, top.dim)) + 1j * rng.normal(size=(3, top.dim))
    ve = tkit.embed(v)
    n0 = tsplit.realpair_applications
    out = tsplit.apply_realpair_flat(tkit.dev, torch.from_numpy(ve)).numpy()
    assert tsplit.realpair_applications == n0 + 1
    for b in range(3):
        wr, wi = jsplit.apply_realpair_flat(jkit[0], ve[b].real, ve[b].imag)
        ref = np.asarray(wr) + 1j * np.asarray(wi)
        np.testing.assert_allclose(out[b], ref, rtol=0,
                                   atol=1e-13 * np.abs(ref).max())
    oracle = np.stack([top.matvec_np(row) for row in v])
    np.testing.assert_allclose(tkit.extract(out), oracle, rtol=0,
                               atol=1e-12 * np.abs(out).max())
    # batched: one operator per member (here the same one stacked)
    pad = tuple(tkit.dev.diag.shape)
    stacked = tsplit.stack_real_ops([top, top, top], pad, device="cpu")
    outb = tsplit.apply_realpair_flat(stacked, torch.from_numpy(ve)).numpy()
    np.testing.assert_allclose(outb, out, rtol=0,
                               atol=1e-14 * np.abs(out).max())


KW = dict(nlat=2, norb=1, nspin=1, nbath=2, uloc=[2.5], lmats=16, lreal=8,
          lanc_ngfiter=40, ed_verbose=0)


def _hloc():
    h = np.zeros((2, 2, 1, 1, 1, 1), np.complex128)
    h[0, 1, 0, 0, 0, 0] = h[1, 0, 0, 0, 0, 0] = -1.0
    return h


def _basis(bond: bool):
    """The replica bath basis of the JAX test (on-site levels); ``bond``
    adds the zero-weight element i (c+_0 c_1 - h.c.)."""
    basis = np.zeros((2 if bond else 1, 2, 2, 1, 1, 1, 1), np.complex128)
    basis[0, 0, 0], basis[0, 1, 1] = 1.0, 1.0
    lam = np.array([[0.4], [-0.4]])
    if bond:
        basis[1, 0, 1], basis[1, 1, 0] = 1j, -1j
        lam = np.concatenate([lam, np.zeros((2, 1))], axis=1)
    return basis, lam


def _solve(pkg, gfmod, mp, workdir, bond=False, force_chan4=False, **kw):
    """One solve; ``force_chan4`` disables the 2-channel auto-detection
    as tests/test_real_fastpath.py:161-172 does.  Returns (G, Sigma)."""
    cfg = pkg.EDConfig(work_dir=str(workdir), **dict(KW, **kw))
    s = pkg.EDSolver(cfg, device="cpu") if pkg is tpkg else pkg.EDSolver(cfg)
    s.set_hbath(*_basis(bond))
    b = s.init_solver()
    if force_chan4:
        orig = gfmod.build_gf_normal

        def forced(*args, **kwargs):
            kwargs["force_symmetric"] = False
            return orig(*args, **kwargs)
        mp.setattr(gfmod, "build_gf_normal", forced)
    s.solve(b, _hloc())
    if force_chan4:
        mp.setattr(gfmod, "build_gf_normal", orig)
    assert s.gf.spectrum.symmetric is not (force_chan4 or bond)
    return s.gf.gmats.copy(), s.gf.smats.copy()


@pytest.fixture
def pair_kit_calls(monkeypatch):
    """Counts the pair-kit applications of the test."""
    calls = []
    orig = tsplit.apply_pair_flat

    def counted(dev, x):
        calls.append(tuple(x.shape))
        return orig(dev, x)
    monkeypatch.setattr(tsplit, "apply_pair_flat", counted)
    return calls


@pytest.mark.parametrize("bond", [False, True],
                         ids=["forced_chan4", "zero_weight_complex_basis"])
def test_chan4_real_problem_matches(tmp_path, monkeypatch, pair_kit_calls,
                                    bond):
    monkeypatch.setenv("CDMFT_SPLIT_BACKEND", "1")
    force = not bond
    g2, s2 = _solve(tpkg, tgf, monkeypatch, tmp_path)
    n0 = tsplit.realpair_applications
    g4, s4 = _solve(tpkg, tgf, monkeypatch, tmp_path, bond=bond,
                    force_chan4=force)
    assert tsplit.realpair_applications > n0
    assert pair_kit_calls == []
    np.testing.assert_allclose(g4, g2, rtol=0, atol=1e-8)
    np.testing.assert_allclose(s4, s2, rtol=0, atol=1e-6)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jg4, js4 = _solve(jpkg, jgf, monkeypatch, jdir, bond=bond,
                      force_chan4=force)
    np.testing.assert_allclose(g4, jg4, rtol=0, atol=1e-10)
    np.testing.assert_allclose(s4, js4, rtol=0, atol=1e-10)


def test_chan4_real_problem_single_precision(tmp_path, pair_kit_calls,
                                             monkeypatch):
    g2, _ = _solve(tpkg, tgf, monkeypatch, tmp_path,
                   ed_gf_precision="single")
    n0 = tsplit.realpair_applications
    g4, s4 = _solve(tpkg, tgf, monkeypatch, tmp_path, bond=True,
                    ed_gf_precision="single")
    assert tsplit.realpair_applications > n0 and pair_kit_calls == []
    np.testing.assert_allclose(g4, g2, rtol=0, atol=1e-5)
    assert np.isfinite(s4).all()
