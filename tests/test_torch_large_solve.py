"""Whole solves through the port's large-sector kits against the JAX
package.

``split.DENSE_FACTOR_MAX`` is lowered in both packages so that small
sectors take the large kits, as tests/test_large_sector.py:142-171 does,
and the sweep is limited to one sector by the reference's own mechanism
(``ed_sectors`` with a ``sectors_list.restart``, shift 0: the cut of the
card's Ns=16 smoke run).  The JAX side runs its split backend
(CDMFT_SPLIT_BACKEND=1) in f64; the port runs f64 and mixed.  egs,
densities, energies and both density matrices are held to 1e-9; G(iw)
and Sigma(iw) to 1e-9 of their largest entry in f64 and 2e-5 in mixed,
on the real 2-site case and on the complex Ns=6 case of
tests/bhz_case.py.  The port keeps its large-sector vectors as tensors,
so these also run its device excitations and device observables.
"""
import dataclasses

import numpy as np
import pytest
import threadpoolctl
import torch

import bhz_case
import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_tpu.models import bhz as jbhz
from cdmft_lanc_ed_tpu.ops import split as jsplit
from cdmft_lanc_ed_torch.carry import state_from_numpy
from cdmft_lanc_ed_torch.models import bhz as tbhz
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


def _compare_solves(j, t, rtol_gf, rtol=1e-9):
    """egs and the one-body results to ``rtol``; G(iw) and Sigma(iw) to
    ``rtol_gf`` of their largest entry.  (On the real axis the broadened
    poles of the unreorthogonalised GF chains amplify rounding; the other
    parity files compare Matsubara data too.)"""
    assert abs(t.egs - j.egs) <= rtol * abs(j.egs)
    for name in ("gimp_matsubara", "sigma_matsubara"):
        a, b = getattr(t, name)(), np.asarray(getattr(j, name)())
        assert np.abs(a - b).max() <= rtol_gf * np.abs(b).max(), name
    tol = max(rtol, rtol_gf / 100)
    for name in ("dens", "docc", "cluster_dm", "sp_dm"):
        np.testing.assert_allclose(getattr(t, name)(),
                                   np.asarray(getattr(j, name)()),
                                   rtol=0, atol=tol, err_msg=name)
    for name in ("eknot", "epot"):
        np.testing.assert_allclose(getattr(t.energy, name),
                                   getattr(j.energy, name), rtol=0,
                                   atol=tol, err_msg=name)


def _restricted(workdir, sector: str):
    """A work directory whose sectors_list.restart limits the sweep to
    one sector (ed_sectors=True, ed_sectors_shift=0: the smoke's Ns=16
    cut)."""
    workdir.mkdir(exist_ok=True)
    (workdir / "sectors_list.restart").write_text(f" {sector}\n")
    return str(workdir)


@pytest.fixture(scope="module")
def forced_large():
    """Large kits for every factor above ``limit`` in both packages, the
    JAX side on its split backend."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CDMFT_SPLIT_BACKEND", "1")

    def force(limit):
        mp.setattr(jsplit, "DENSE_FACTOR_MAX", limit)
        mp.setattr(tsplit, "DENSE_FACTOR_MAX", limit)

    yield force
    mp.undo()


# the 2-site real case of tests/test_large_sector.py:142-171 (Ns=4): the
# half-filled (2,2) sector and its GF targets have a 6-state factor.
# beta=50 (not the default 1000) keeps the lowest Matsubara frequency
# away from zero, where Sigma = G0^-1 - G^-1 would amplify the last digits
# of G ~1e5 times (measured: G agrees to 2e-14, Sigma(iw_0) to 3e-8).
REAL_KW = dict(nlat=2, norb=1, nspin=1, nbath=1, uloc=[2.0], beta=50.0,
               lmats=32,
               lreal=16, lanc_dim_threshold=4, ed_verbose=0, dm_flag=True,
               ed_sectors=True, ed_sectors_shift=0)


def _real_solve(pkg, workdir, prec):
    cfg = pkg.EDConfig(work_dir=_restricted(workdir, "2 2"),
                       ed_precision=prec, **REAL_KW)
    nn = (2, 2, 1, 1, 1, 1)
    hloc = np.zeros(nn, np.complex128)
    hloc[0, 1, 0, 0, 0, 0] = hloc[1, 0, 0, 0, 0, 0] = -1.0
    basis = np.zeros((1,) + nn, np.complex128)
    for il in range(2):
        basis[0, il, il, 0, 0, 0, 0] = 1.0
    solver = pkg.EDSolver(cfg, **({"device": "cpu"} if pkg is tpkg
                                  else {}))
    solver.set_hbath(basis, np.array([[0.3]]))
    solver.solve(solver.init_solver(), hloc)
    return solver


def _bhz_solve(pkg, workdir, prec, jbath=None):
    """The complex Ns=6 case restricted to its (3,3) sector; the port
    takes JAX's bath array (``jbath``) through carry.state_from_numpy."""
    kw = dict(bhz_case.KW, ed_precision=prec, ed_sectors=True,
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


@pytest.fixture(scope="module")
def real_runs(tmp_path_factory, forced_large):
    """The JAX f64 solve and the port's solves in both precisions, with
    the 6-state factors on the large kits."""
    forced_large(5)
    from cdmft_lanc_ed_torch import diag as tdiag
    seen = []
    solve_large = tdiag._solve_large

    def spy(cfg, op, *a):
        seen.append(tsplit.op_is_real(op))
        return solve_large(cfg, op, *a)

    mp = pytest.MonkeyPatch()
    mp.setattr(tdiag, "_solve_large", spy)
    try:
        j = _real_solve(jpkg, tmp_path_factory.mktemp("jax"), "complex128")
        t = {p: _real_solve(tpkg, tmp_path_factory.mktemp(p), p)
             for p in ("complex128", "mixed")}
    finally:
        mp.undo()
    return j, t, seen


@pytest.fixture(scope="module")
def bhz_runs(tmp_path_factory, forced_large):
    """As ``real_runs`` on the complex case: its 20-state factors on the
    large kits."""
    forced_large(15)
    j, jbath = _bhz_solve(jpkg, tmp_path_factory.mktemp("jax"),
                          "complex128")
    t = {p: _bhz_solve(tpkg, tmp_path_factory.mktemp(p), p, jbath)
         for p in ("complex128", "mixed")}
    return j, t


# the port's mixed solve is held to JAX's f64 one at the JAX suite's
# mixed-vs-f64 Sigma bound (tests/test_mixed_baseline_configs.py:41-49)
PRECISIONS = [("complex128", 1e-9), ("mixed", 2e-5)]


@pytest.mark.parametrize("prec,rtol_gf", PRECISIONS)
def test_real_solve_matches_jax(real_runs, prec, rtol_gf):
    j, t, seen = real_runs
    assert seen and all(seen)               # real sectors, large kit
    states = t[prec].diag_state.state_list
    assert all(isinstance(st.get_vector(4), torch.Tensor) for st in states)
    _compare_solves(j, t[prec], rtol_gf)


@pytest.mark.parametrize("prec,rtol_gf", PRECISIONS)
def test_complex_solve_matches_jax(bhz_runs, prec, rtol_gf):
    j, t = bhz_runs
    vec = t[prec].diag_state.state_list[0].vector
    assert isinstance(vec, torch.Tensor) and vec.is_complex()
    _compare_solves(j, t[prec], rtol_gf)


def test_single_precision_gf_takes_the_f32_tile_kit(tmp_path, monkeypatch):
    """ed_gf_precision="single": the GF chains of a large target sector
    run on the f32 tile kit (beta floor 1e-6) and agree with the dense
    kit's single-precision chains (the same f32 algorithm; the tiles sum
    in another order) to 1e-5."""
    from cdmft_lanc_ed_torch.ops import large as tlarge
    built = []
    build_real = tlarge.to_device_large_real

    def spy(op, dtype=torch.float32, **kw):
        built.append(dtype)
        return build_real(op, dtype=dtype, **kw)

    monkeypatch.setattr(tlarge, "to_device_large_real", spy)
    out = {}
    for limit in (8192, 5):
        monkeypatch.setattr(tsplit, "DENSE_FACTOR_MAX", limit)
        cfg = tpkg.EDConfig(work_dir=_restricted(tmp_path / str(limit),
                                                 "2 2"),
                            ed_precision="complex128",
                            ed_gf_precision="single",
                            **dict(REAL_KW, dm_flag=False))
        nn = (2, 2, 1, 1, 1, 1)
        hloc = np.zeros(nn, np.complex128)
        hloc[0, 1, 0, 0, 0, 0] = hloc[1, 0, 0, 0, 0, 0] = -1.0
        basis = np.zeros((1,) + nn, np.complex128)
        basis[0, 0, 0, 0, 0, 0, 0] = basis[0, 1, 1, 0, 0, 0, 0] = 1.0
        s = tpkg.EDSolver(cfg, device="cpu")
        s.set_hbath(basis, np.array([[0.3]]))
        s.solve(s.init_solver(), hloc)
        out[limit] = s.gimp_matsubara()
    assert torch.float32 in built
    g, ref = out[5], out[8192]
    assert np.abs(g - ref).max() <= 1e-5 * np.abs(ref).max()
