"""The dw-sharded route of a mesh-installed EDSolver against the JAX
package's on the same (1, 2) layout.

The complex Ns=6 case of tests/bhz_case.py at lanc_dim_threshold=4: its
five sectors of dim >= 256 take the sharded block-sparse kits on two gloo
ranks (``torch_dist_case.mesh_solves``, spawned with
torch.multiprocessing), with ``split.DENSE_FACTOR_MAX`` lowered to 15 in
both packages so that the GF chains of its 20-state factors run on the
sharded appliers too.  The JAX package runs in this process on two of the
virtual CPU devices with ``CDMFT_SPLIT_BACKEND=1``.  f64: egs 1e-8,
densities 1e-7, Sigma rtol 1e-7 / atol 1e-9.  Mixed: held to the same
f64 solve at the mixed bounds of tests/test_mixed_baseline_configs.py:
41-49 (egs 1e-7, densities 1e-6, Sigma rtol 2e-5 / atol 1e-5).  The
JAX package's own mixed solve on this route stops on an
UnboundLocalError (``jnp`` in diag.py's complex mixed mesh branch,
:467-468), so it cannot be the reference.
"""
import pytest

import torch_dist_case as case
from test_torch_mesh_solve import F64, MIXED, check, jax_runs

DENSE_MAX = 15
CASES = [
    ("bhz_dw", "bhz_solve", dict(threshold=4), F64, "bhz_dw"),
    ("bhz_dw_mixed", "bhz_solve", dict(threshold=4, prec="mixed"), MIXED,
     "bhz_dw"),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dw")
    ref, cases = jax_runs(CASES, 1, tmp, dense_max=DENSE_MAX)
    got = case.run("mesh_solves", 2, tmp, n_sector=1, cases=cases,
                   tmpdir=str(tmp), dense_max=DENSE_MAX)
    return ref, got


@pytest.mark.parametrize("name,bounds,of", [(c[0], c[3], c[4])
                                            for c in CASES],
                         ids=[c[0] for c in CASES])
def test_dw_sharded_route_matches_jax(runs, name, bounds, of):
    ref, got = runs
    for rank in got:                  # every rank ends with the results
        check(ref[of], rank[name], bounds)
    routes = got[0][name]["routes"]
    assert sum(r[0] == "sharded" for r in routes) == 5
