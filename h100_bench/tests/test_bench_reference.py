"""The plain reference against the program on the CPU at Ns=8, and the
bath-less plaquette's anchor."""
import numpy as np
import pytest
import torch

import bench_helpers  # noqa: F401  (paths)
from reference.cluster_ed import solve
from reference.replica_hubbard import problem_of

HOP = np.array([[0, -1, -1, 0], [-1, 0, 0, -1], [-1, 0, 0, -1],
                [0, -1, -1, 0]], float)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_bathless_plaquette_anchor():
    p = problem_of(HOP, levels=[], v=[], u=4.0, xmu=0.0, beta=100.0,
                   lmats=16, ngfiter=30)
    sol = solve(p, [(2, 2), (1, 2), (2, 1), (3, 2), (2, 3)])
    assert sol.sectors == [(2, 2)]
    assert abs(sol.egs - (-6.1027484835)) < 1e-8
    assert np.allclose(sol.dens, 1.0, atol=1e-10)
    assert np.allclose(sol.docc, 0.0718, atol=1e-3)


@pytest.mark.parametrize("level,v", [(0.0, 0.5), (0.0, 0.3)])
def test_ns8_against_the_program(tmp_path, level, v):
    from cdmft_lanc_ed_torch import EDConfig, EDSolver
    from cdmft_lanc_ed_torch.bath import DmftBath, pack_dmft_bath
    cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=1, uloc=[4.0],
                   beta=100.0, lmats=64, lreal=8, lanc_ngfiter=60,
                   ed_precision="mixed", ed_verbose=0,
                   work_dir=str(tmp_path))
    s = EDSolver(cfg, device="cpu")
    basis = np.zeros((1, 4, 4, 1, 1, 1, 1), complex)
    basis[0, np.arange(4), np.arange(4)] = 1.0
    s.set_hbath(basis, np.array([[level]]))
    s.init_solver()
    s.solve(pack_dmft_bath(cfg, DmftBath(v=np.full((1, 4), v),
                                         lam=np.array([[level]]))),
            HOP.astype(complex)[:, :, None, None, None, None])
    p = problem_of(HOP, levels=[level], v=[v], u=4.0, xmu=0.0, beta=100.0,
                   lmats=64, ngfiter=60)
    sol = solve(p, [(a, b) for a in (3, 4, 5) for b in (3, 4, 5)])
    ns = cfg.ns
    prog = sorted(((st.isector - 1) // (ns + 1), (st.isector - 1) % (ns + 1))
                  for st in s.diag_state.state_list)
    assert prog == sol.sectors == [(4, 4)]
    assert abs(s.egs - sol.egs) < 1e-10
    gm = s.gimp_matsubara()[:, :, 0, 0, 0, 0]
    sm = s.sigma_matsubara()[:, :, 0, 0, 0, 0]
    assert np.abs(gm - sol.g[0]).max() < 1e-9 * np.abs(sol.g[0]).max()
    assert np.abs(sm - sol.sigma[0]).max() < 1e-8 * np.abs(sol.sigma[0]).max()
    assert np.abs(s.dens()[:, 0] - sol.dens).max() < 1e-10
    assert np.abs(s.docc()[:, 0] - sol.docc).max() < 1e-10


@pytest.mark.parametrize("path", sorted(
    (bench_helpers.BENCH / "reference").glob("*.py")) + sorted(
    (bench_helpers.BENCH / "tests" / "fixtures").glob("*/reference/*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    import ast
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "dataclasses", "itertools", "math",
                     "typing", "numpy", "torch", "warnings", "reference"}
