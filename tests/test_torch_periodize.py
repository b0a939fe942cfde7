"""Periodization, postprocessing, custom observables and the ed_* aliases
of the port against the JAX package.

* Every function of ``periodize.py`` on seeded inputs (a random Hermitian
  H(k), a random causal Sigma(z) of a 2-site, 2-spin, 2-orbital cluster;
  the 4-site, 2-sublattice cell of the SSH M-scheme) to 1e-12.
* The rest of ``postprocess.py``: the Z(k) matrices, both topological
  Hamiltonians, a band structure, the Chern number and the spin Chern /
  Z2 marker of the single-cell BHZ model in both phases, to 1e-12.
* ``CustomObservables`` on the JAX suite's plaquette case
  (tests/test_periodize_customobs.py:146-164): its integrand (Sigma
  rebuilt at arbitrary z, the k-sum, with and without the tail) to 1e-12
  and the integrals to 1e-8, port against JAX, and the total density it
  must give (4 within 0.02).
* The ``compat`` aliases against the solver methods they name.
"""
import numpy as np
import pytest
import threadpoolctl
import torch

import cdmft_lanc_ed_tpu as jpkg
import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_tpu import periodize as jper
from cdmft_lanc_ed_tpu import postprocess as jpost
from cdmft_lanc_ed_tpu.custom_obs import CustomObservables as JCustom
from cdmft_lanc_ed_tpu.models import bhz as jbhz
from cdmft_lanc_ed_torch import compat
from cdmft_lanc_ed_torch import periodize as tper
from cdmft_lanc_ed_torch import postprocess as tpost
from cdmft_lanc_ed_torch.custom_obs import CustomObservables as TCustom
from cdmft_lanc_ed_torch.models import bhz as tbhz
from cdmft_lanc_ed_torch.utils.reshape import nnn2lso


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One BLAS and one intra-op thread: the suite runs in several worker
    processes at once."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(nthreads)


CPU = {"device": "cpu"}
TOL = 1e-12


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(
        np.abs(b).max(), 1.0))


def _herm(rng, n):
    a = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    return 0.5 * (a + a.conj().T)


def _causal_sigma(rng, nlat, nspin, norb, z):
    """A random causal Sigma(z) = S0 + V (z - E)^{-1} V^+ in nnn shape."""
    n = nlat * nspin * norb
    s0, e = _herm(rng, n), np.diag(rng.normal(size=n))
    v = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    s = np.stack([s0 + 0.3 * v @ np.linalg.inv(zz * np.eye(n) - e)
                  @ v.conj().T for zz in z], axis=-1)
    return tpkg.lso2nnn(s, nlat, nspin, norb)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(17)
    nlat, nspin, norb = 2, 2, 2
    z = 1j * np.pi / 10.0 * (2 * np.arange(6) + 1)
    kw = dict(nlat=nlat, norb=norb, nspin=nspin, nbath=0, xmu=0.15)
    return dict(jcfg=jpkg.EDConfig(**kw), tcfg=tpkg.EDConfig(**kw), z=z,
                coords=jper.cluster_coords(nlat, nlat, 1),
                k=np.array([0.7, -0.3]),
                hk_unper=_herm(rng, nlat * nspin * norb),
                hk_per=_herm(rng, nspin * norb),
                hk_hop=_herm(rng, nspin * norb),
                h_local=_herm(rng, nlat * nspin * norb),
                s=_causal_sigma(rng, nlat, nspin, norb, z))


def test_cluster_coords():
    for shape in ((4, 4, 1), (4, 2, 2), (6, 3, 2)):
        np.testing.assert_array_equal(tper.cluster_coords(*shape),
                                      jper.cluster_coords(*shape))
    c = tper.cluster_coords(4, 2, 2)
    _close(tper._phases([0.3, 1.1], c), jper._phases([0.3, 1.1], c))


@pytest.mark.parametrize("name", ["periodize_g_scheme",
                                  "build_sigma_g_scheme",
                                  "periodize_sigma_scheme",
                                  "build_g_sigma_scheme",
                                  "periodize_m_scheme_local"])
def test_periodize_scheme_matches_jax(case, name):
    c = case
    args = {
        "periodize_g_scheme": (c["coords"], c["hk_unper"], c["s"]),
        "build_sigma_g_scheme": (c["coords"], c["hk_unper"], c["hk_per"],
                                 c["s"]),
        "periodize_sigma_scheme": (c["coords"], c["hk_per"], c["s"]),
        "build_g_sigma_scheme": (c["coords"], c["hk_per"], c["s"]),
        "periodize_m_scheme_local": (c["coords"], c["h_local"],
                                     c["hk_hop"], c["hk_per"], c["s"]),
    }[name]
    want = getattr(jper, name)(c["jcfg"], c["k"], *args, c["z"])
    got = getattr(tper, name)(c["tcfg"], c["k"], *args, c["z"], **CPU)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        _close(g, w)


def test_periodize_m_scheme_matches_jax():
    rng = np.random.default_rng(23)
    kw = dict(nlat=4, norb=1, nspin=2, nbath=0, xmu=0.3)
    z = 0.05j + np.linspace(-2, 2, 7)
    s = _causal_sigma(rng, 4, 2, 1, z)
    cell, sub = np.repeat(np.arange(2.0), 2), np.tile([0, 1], 2)
    for k in (0.0, 1.3):
        want = jper.periodize_m_scheme(jpkg.EDConfig(**kw), [k], cell, sub,
                                       2, s, z)
        got = tper.periodize_m_scheme(tpkg.EDConfig(**kw), [k], cell, sub,
                                      2, s, z, **CPU)
        for g, w in zip(got, want):
            _close(g, w)


def bhz_hk_fn(pkg_bhz, mh, ts=0.25, lam=0.3):
    """The single-cell BHZ model of tests/test_postprocess.py:10-20."""
    def hk(k):
        h = pkg_bhz.bhz_cluster_hloc(1, 1, mh, ts, lam).copy()
        for s in range(2):
            h[0, 0, s, s] += pkg_bhz.t_x(ts, lam, s).conj().T \
                * np.exp(1j * k[0]) + pkg_bhz.t_x(ts, lam, s) \
                * np.exp(-1j * k[0]) + pkg_bhz.t_y(ts, lam).T \
                * np.exp(1j * k[1]) + pkg_bhz.t_y(ts, lam) * np.exp(-1j * k[1])
        return nnn2lso(h, 1, 2, 2)
    return hk


RECIP = 2 * np.pi * np.eye(2)


def test_postprocess_matches_jax():
    rng = np.random.default_rng(29)
    cfg_j = jpkg.EDConfig(nlat=1, norb=2, nspin=2, beta=20.0)
    cfg_t = tpkg.EDConfig(nlat=1, norb=2, nspin=2, beta=20.0)
    sig = 0.3 * _herm(rng, 4) - 0.2j * np.eye(4)
    for fn in ("zmats_matrix", "zmats_component"):
        _close(getattr(tpost, fn)(cfg_t, sig), getattr(jpost, fn)(cfg_j, sig))
    hk = bhz_hk_fn(jbhz, 0.5)
    s0 = _herm(rng, 4)
    k = np.array([0.4, -1.2])
    _close(tpost.topological_hamiltonian(hk, lambda q: s0)(k),
           jpost.topological_hamiltonian(hk, lambda q: s0)(k))
    _close(tpost.unperiodized_topological_hamiltonian(hk, s0)(k),
           jpost.unperiodized_topological_hamiltonian(hk, s0)(k))
    path = [np.zeros(2), np.array([np.pi, 0]), np.array([np.pi, np.pi])]
    for got, want in zip(tpost.band_structure(hk, path, npts=7, **CPU),
                         jpost.band_structure(hk, path, npts=7)):
        _close(got, want)
    assert tpost.chern_number(hk, RECIP, 6, [0, 1], **CPU) == \
        pytest.approx(jpost.chern_number(hk, RECIP, 6, [0, 1]), abs=TOL)
    # both phases of the JAX suite's spin Chern test
    for mh, want in ((0.5, 1), (2.0, 0)):
        got = tpost.spin_chern_z2(bhz_hk_fn(tbhz, mh), RECIP, 12,
                                  4, 1, **CPU)
        ref = jpost.spin_chern_z2(bhz_hk_fn(jbhz, mh), RECIP, 12, 4, 1)
        np.testing.assert_allclose(got[:2], ref[:2], rtol=0, atol=TOL)
        assert got[2] == ref[2] == want
        assert abs(abs(got[0]) - want) < 1e-6 and abs(got[0] + got[1]) < 1e-6


def _plaquette():
    h = np.zeros((4, 4, 1, 1, 1, 1), dtype=complex)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        h[i, j, 0, 0, 0, 0] = h[j, i, 0, 0, 0, 0] = -1.0
    return h


def test_custom_observable_matches_jax(tmp_path):
    h = _plaquette()
    kw = dict(nlat=4, norb=1, nspin=1, nbath=0, uloc=[4.0], lmats=16,
              lreal=16, lanc_ngfiter=48, ed_verbose=0)
    vals, sums = [], []
    for pkg, custom, dev in ((jpkg, JCustom, {}), (tpkg, TCustom, CPU)):
        wd = tmp_path / pkg.__name__
        wd.mkdir()
        s = pkg.EDSolver(pkg.EDConfig(work_dir=str(wd), **kw), **dev)
        s.init_solver()
        s.solve(np.zeros(0), h)
        co = custom(s, nnn2lso(h, 4, 1, 1).reshape(1, 4, 4))
        co.add("ntot", np.eye(4))
        co.add("bond", nnn2lso(h, 4, 1, 1))
        vals.append(co.compute())
        # the integrand itself (Sigma rebuilt at arbitrary z, the k-sum)
        z = np.array([0.3j, 1.7j, 0.5 + 0.2j])
        sums.append([co._ksum(z, item.sij, tail) for item in co.items
                     for tail in (False, True)])
    _close(sums[1], sums[0])
    assert vals[1]["ntot"] == pytest.approx(4.0, abs=0.02)
    for name in ("ntot", "bond"):
        assert vals[1][name] == pytest.approx(vals[0][name], abs=1e-8)
    co.write()
    text = (tmp_path / tpkg.__name__ / "custom_observables_last.ed") \
        .read_text().split()
    assert text[0] == "ntot"
    assert float(text[1]) == pytest.approx(vals[1]["ntot"], abs=1e-14)


def test_compat_aliases(tmp_path):
    cfg = tpkg.EDConfig(nlat=1, norb=1, nspin=1, nbath=1, beta=10.0,
                        lmats=16, lreal=8, lanc_ngfiter=16, ed_verbose=0,
                        work_dir=str(tmp_path))
    s = tpkg.EDSolver(cfg, **CPU)
    compat.ed_set_hbath(s, np.ones((1, 1, 1, 1, 1, 1, 1)), np.array([[0.3]]))
    assert compat.ed_get_bath_dimension(s) == s.get_bath_dimension()
    with pytest.raises(RuntimeError, match="Hloc"):
        compat._hloc_state(s)
    bath = compat.ed_init_solver(s)
    hloc = np.zeros((1, 1, 1, 1, 1, 1))
    compat.ed_solve(s, bath, hloc)
    for name in ("sigma_matsubara", "sigma_realaxis", "gimp_matsubara",
                 "gimp_realaxis", "g0imp_matsubara", "g0imp_realaxis",
                 "dens", "docc", "mag"):
        assert getattr(compat, "ed_get_" + name)(s) is getattr(s, name)()
    e = s.energy
    np.testing.assert_array_equal(compat.ed_get_eimp(s),
                                  [e.epot, e.eknot, e.ehartree, 0.0])
    np.testing.assert_array_equal(compat.ed_get_doubles(s),
                                  [e.dust, e.dund, e.dse, e.dph])
    z = 1j * s.gf.wm[:3]
    np.testing.assert_array_equal(compat.ed_gf_cluster(s, z),
                                  s.gf_cluster(z))
    zm = 1j * s.gf.wm
    zr = s.gf.wr + 1j * cfg.eps
    for fn, ref in (("delta", lambda z_: tpkg.delta_bath(
            cfg, s.hb, s.bath, z_, **CPU)),
            ("g0and", lambda z_: tpkg.g0and_bath(cfg, s.hb, s.bath, hloc,
                                                 z_, **CPU)),
            ("invg0and", lambda z_: tpkg.invg0_bath(cfg, s.hb, s.bath, hloc,
                                                    z_, **CPU))):
        _close(getattr(compat, f"ed_get_{fn}_matsubara")(s), ref(zm))
        _close(getattr(compat, f"ed_get_{fn}_realaxis")(s), ref(zr))
    # the Andersen G0 of the solved bath is the solver's impurity G0
    _close(compat.ed_get_g0and_matsubara(s), s.g0imp_matsubara(), 1e-12)
    fitted = compat.ed_chi2_fitgf(s, s.gimp_matsubara(), bath, hloc)
    assert fitted.shape == bath.shape and np.isfinite(fitted).all()
    compat.ed_print_impsigma(s)
    compat.ed_print_impg(s)
    compat.ed_print_impg0(s)
    smats, _ = compat.ed_read_impsigma(s)
    np.testing.assert_array_equal(smats, s.sigma_matsubara())
    gmats, _ = compat.ed_read_impg(s)
    np.testing.assert_array_equal(gmats, s.gimp_matsubara())
    np.testing.assert_array_equal(compat.ed_spin_symmetrize_bath(s, bath),
                                  bath)
