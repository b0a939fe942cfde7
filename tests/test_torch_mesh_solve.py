"""EDSolver with an installed mesh against the JAX package with the same
layout.

The port runs on two gloo ranks spawned with torch.multiprocessing
(``torch_dist_case.mesh_solves``), the JAX package in this process on a
mesh of two of the virtual CPU devices, with ``CDMFT_SPLIT_BACKEND=1`` as
tests/test_sharded_spmv.py:111-152 and tests/test_sector_parallel.py:
44-153 run it.

* (1, 2) mesh: the bath-less plaquette at lanc_dim_threshold=1 (egs 1e-8,
  densities 1e-7; its sectors are all below 64, so none is sharded:
  tests/test_torch_mesh_dw.py holds the sharded route).
* (2, 1) mesh, the sector-parallel route: the real 2-site + 1 bath case
  of tests/test_sector_parallel.py:117-153 and the complex Ns=6 case of
  tests/bhz_case.py at its lanc_dim_threshold=16, same-bucket batches
  split over the two ranks; f64 against the JAX package's f64 solve
  (egs 1e-8, densities 1e-7, Sigma to rtol 1e-7 / atol 1e-9 as
  tests/test_sector_parallel.py:151-153 holds it), mixed against the same
  f64 solve at the mixed bounds of tests/test_mixed_baseline_configs.py:
  41-49 (egs 1e-7, densities 1e-6, Sigma rtol 2e-5 / atol 1e-5).
"""
import numpy as np
import pytest

import cdmft_lanc_ed_tpu as jpkg
import torch_dist_case as case
from cdmft_lanc_ed_tpu.ops import split as jsplit
from cdmft_lanc_ed_tpu.parallel import multichip as jmc

# Sigma: (rtol, atol) of tests/test_sector_parallel.py:151-153 in f64 and
# of tests/test_mixed_baseline_configs.py:41-49 in mixed
F64 = dict(egs=1e-8, dens=1e-7, sigma=(1e-7, 1e-9))
MIXED = dict(egs=1e-7, dens=1e-6, sigma=(2e-5, 1e-5))

# (name, solver of torch_dist_case, kwargs, bounds, the JAX solve it is
# held to: its own name, or the f64 case a mixed one is held to)
DW_CASES = [
    ("plaquette", "plaquette_solve", {}, F64, "plaquette"),
]
SECTOR_CASES = [
    ("pair_bath", "pair_bath_solve", {}, F64, "pair_bath"),
    ("pair_bath_mixed", "pair_bath_solve", dict(prec="mixed"), MIXED,
     "pair_bath"),
    ("bhz", "bhz_solve", {}, F64, "bhz"),
    ("bhz_mixed", "bhz_solve", dict(prec="mixed"), MIXED, "bhz"),
]


def jax_runs(cases, n_sector, tmp_path, dense_max=None):
    """The JAX package's solves of ``cases`` that are their own
    reference, on a (n_sector, 2 // n_sector) mesh, and the port's cases,
    a complex one with the JAX configuration and bath."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CDMFT_SPLIT_BACKEND", "1")
    if dense_max:
        mp.setattr(jsplit, "DENSE_FACTOR_MAX", dense_max)
    jmc.set_solver_mesh(jmc.make_mesh(2, n_sector=n_sector))
    ref, extra = {}, {}
    try:
        for name, fn, kw, _, of in cases:
            if of != name:
                continue
            wd = tmp_path / f"jax_{name}"
            wd.mkdir()
            s = getattr(case, fn)(jpkg, str(wd), **kw)
            if isinstance(s, tuple):
                s, jbath, jfields = s
                extra[name] = dict(jbath=jbath, jfields=jfields)
            ref[name] = case.results_of(s)
    finally:
        jmc.set_solver_mesh(None)
        mp.undo()
    port = [(name, fn, dict(kw, **extra.get(of, {})))
            for name, fn, kw, _, of in cases]
    return ref, port


@pytest.fixture(scope="module")
def dw_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dw")
    ref, cases = jax_runs(DW_CASES, 1, tmp)
    got = case.run("mesh_solves", 2, tmp, n_sector=1, cases=cases,
                   tmpdir=str(tmp))
    return ref, got


@pytest.fixture(scope="module")
def sector_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sector")
    ref, cases = jax_runs(SECTOR_CASES, 2, tmp)
    got = case.run("mesh_solves", 2, tmp, n_sector=2, cases=cases,
                   tmpdir=str(tmp))
    return ref, got


def check(ref, got, bounds):
    assert abs(got["egs"] - ref["egs"]) <= bounds["egs"]
    np.testing.assert_allclose(got["dens"], ref["dens"], rtol=0,
                               atol=bounds["dens"])
    if "smats" in ref:
        rtol, atol = bounds["sigma"]
        np.testing.assert_allclose(got["smats"], ref["smats"], rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("name,bounds,of",
                         [(c[0], c[3], c[4]) for c in DW_CASES],
                         ids=[c[0] for c in DW_CASES])
def test_dw_mesh_matches_jax(dw_runs, name, bounds, of):
    ref, got = dw_runs
    for rank in got:                  # every rank ends with the results
        check(ref[of], rank[name], bounds)
    assert not any(r[0] == "sharded" for r in got[0][name]["routes"])


@pytest.mark.parametrize("name,bounds,of",
                         [(c[0], c[3], c[4]) for c in SECTOR_CASES],
                         ids=[c[0] for c in SECTOR_CASES])
def test_sector_mesh_matches_jax(sector_runs, name, bounds, of):
    ref, got = sector_runs
    for rank in got:
        check(ref[of], rank[name], bounds)
    routes = got[0][name]["routes"]
    assert any(r[0] == "batched" for r in routes)
    assert not any(r[0] == "sharded" for r in routes)
