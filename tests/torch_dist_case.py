"""Multi-process cases of the port's parallel layer, and the models they
share with their JAX references.

The port's side runs in processes spawned with torch.multiprocessing,
one per rank, joined by gloo through a ``FileStore`` under the test's
``tmp_path`` (no fixed port, so test workers can run at once).  This
module imports no JAX, so the children stay light; the functions below
take the package module (the port, or in the parent the JAX package) and
build the same operators and solvers in either.  Each child holds one BLAS and
one intra-op thread.
"""
import dataclasses
import importlib
import pathlib
import pickle
import sys
import uuid

import numpy as np
import threadpoolctl
import torch
import torch.multiprocessing as tmp

import bhz_case


def run(case, world, tmp_path, n_sector=1, **kw):
    """Run ``case`` (a function of this module taking (mesh, rank,
    **kw)) on ``world`` gloo ranks on a (n_sector, world // n_sector)
    mesh; returns each rank's result.  A rank that fails fails the
    call."""
    # a fresh store file: one left by an earlier run hangs the rendezvous
    store = str(tmp_path / f"store_{uuid.uuid4().hex}")
    # the children take this process's sys.path: make it name the repo
    # and this directory absolutely (tests run from a scratch cwd)
    here = pathlib.Path(__file__).resolve().parent
    saved = list(sys.path)
    sys.path[:0] = [str(here.parent), str(here)]
    try:
        tmp.spawn(_entry, args=(world, store, case, n_sector, kw,
                                str(tmp_path)), nprocs=world, join=True)
    finally:
        sys.path[:] = saved
    out = []
    for r in range(world):
        with open(tmp_path / f"{case}_{world}_{n_sector}_{r}.pkl",
                  "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _entry(rank, world, store_path, case, n_sector, kw, out_dir):
    torch.set_num_threads(1)
    from cdmft_lanc_ed_torch.parallel import distributed, multichip
    store = torch.distributed.FileStore(store_path, world)
    mesh = distributed.init_distributed(n_sector, device="cpu",
                                        store=store, rank=rank,
                                        world_size=world)
    try:
        with threadpoolctl.threadpool_limits(1):
            out = globals()[case](mesh, rank, **kw)
    finally:
        multichip.set_solver_mesh(None)
        torch.distributed.destroy_process_group()
    with open(f"{out_dir}/{case}_{world}_{n_sector}_{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)


# ---------------------------------------------------------------------------
# operators (tests/test_large_sector.py:17-36, tests/test_sharded_spmv.py)
# ---------------------------------------------------------------------------

def hubbard_op(pkg, nup, ndw, nbath=1, jh=0.0, complex_h=False):
    """The 2-site sector of tests/test_large_sector.py:17-36."""
    sh = importlib.import_module(pkg.__name__ + ".ops.sector_ham")
    norb = 2 if jh else 1
    nlat = 2
    cfg = pkg.EDConfig(nlat=nlat, norb=norb, nspin=1, nbath=nbath,
                       uloc=[2.0] * norb, ust=0.5 if jh else 0.0, jh=jh,
                       jx=jh, jp=jh, ed_verbose=0)
    nn = (nlat, nlat, 1, 1, norb, norb)
    hloc = np.zeros(nn, np.complex128)
    for o in range(norb):
        hloc[0, 1, 0, 0, o, o] = -1.0 + (0.3j if complex_h else 0.0)
        hloc[1, 0, 0, 0, o, o] = np.conj(hloc[0, 1, 0, 0, o, o])
    hrec = np.zeros((nbath,) + nn, np.complex128)
    for b in range(nbath):
        for il in range(nlat):
            for o in range(norb):
                hrec[b, il, il, 0, 0, o, o] = -0.4 + 0.8 * b
    dhyb = np.full((nlat, 1, norb, nbath), 0.45)
    return sh.build_sector_operator(cfg, hloc, hrec, dhyb, nup, ndw)


def spmv_op(pkg, nup=3, ndw=3, jx=0.0, jp=0.0, norb=1, nlat=2, nbath=2,
            realify=False):
    """The sector of tests/test_sharded_spmv.py:13-27 (``realify``: its
    hoppings' imaginary parts dropped, as :36-45 does)."""
    sh = importlib.import_module(pkg.__name__ + ".ops.sector_ham")
    cfg = pkg.EDConfig(nlat=nlat, norb=norb, nspin=1, nbath=nbath,
                       uloc=[3.0, 1.5, 0, 0, 0], ust=0.4, jh=0.1, jx=jx,
                       jp=jp, ed_verbose=0)
    rng = np.random.default_rng(7)
    nn = (cfg.nlat, cfg.nlat, cfg.nspin, cfg.nspin, cfg.norb, cfg.norb)
    h = rng.normal(size=nn) + 1j * rng.normal(size=nn)
    h = 0.5 * (h + h.conj().transpose(1, 0, 3, 2, 5, 4))
    hrec = rng.normal(size=(cfg.nbath,) + nn) * 0.5
    hrec = 0.5 * (hrec + hrec.transpose(0, 2, 1, 4, 3, 6, 5))
    dhyb = rng.normal(size=(cfg.nlat, cfg.nspin, cfg.norb, cfg.nbath))
    op = sh.build_sector_operator(cfg, h, hrec.astype(np.complex128), dhyb,
                                  nup, ndw)
    if realify:
        op.h_up.vals = op.h_up.vals.real.astype(np.complex128)
        op.h_dw.vals = op.h_dw.vals.real.astype(np.complex128)
    return op


def real_spmv_op(pkg):
    """The real sector with Jx/Jp of tests/test_sharded_spmv.py:155-166."""
    sh = importlib.import_module(pkg.__name__ + ".ops.sector_ham")
    cfg = pkg.EDConfig(nlat=1, norb=2, nspin=1, nbath=2,
                       uloc=[3.0, 1.5, 0, 0, 0], ust=0.4, jh=0.1, jx=0.2,
                       jp=0.1, ed_verbose=0)
    rng = np.random.default_rng(7)
    nn = (1, 1, 1, 1, 2, 2)
    h = rng.normal(size=nn).astype(complex)
    h = 0.5 * (h + h.conj().transpose(1, 0, 3, 2, 5, 4))
    hrec = (rng.normal(size=(2,) + nn) * 0.5).astype(complex)
    hrec = 0.5 * (hrec + hrec.conj().transpose(0, 2, 1, 4, 3, 6, 5))
    dhyb = rng.normal(size=(1, 1, 2, 2))
    return sh.build_sector_operator(cfg, h, hrec, dhyb, 3, 2)


# (name, hubbard_op kwargs, complex vector, tile dtype) of every sharded
# large-sector matvec case; the vector is drawn from default_rng(seed)
LARGE_CASES = [
    ("real_f64", dict(nup=3, ndw=3, nbath=2), False, "float64", 9),
    ("real_f32", dict(nup=3, ndw=3, nbath=2), False, "float32", 9),
    ("real_jxjp", dict(nup=2, ndw=2, nbath=1, jh=0.3), False, "float64",
     10),
    ("pair", dict(nup=2, ndw=2, complex_h=True), True, "float64", 12),
    ("pair_f32", dict(nup=2, ndw=2, complex_h=True), True, "float32", 12),
    ("pair_jxjp", dict(nup=2, ndw=2, jh=0.3, complex_h=True), True,
     "float64", 13),
]


def vector(dim, cplx, seed, rows=None):
    rng = np.random.default_rng(seed)
    shape = (dim,) if rows is None else (rows, dim)
    v = rng.normal(size=shape)
    return v + 1j * rng.normal(size=shape) if cplx else v


def matvecs(mesh, rank):
    """The port's sharded matvecs on every case, whole vectors out."""
    import cdmft_lanc_ed_torch as tpkg
    from cdmft_lanc_ed_torch.ops import lanczos
    from cdmft_lanc_ed_torch.parallel import sharded_large as sl
    from cdmft_lanc_ed_torch.parallel import sharded_spmv as ss
    out = {}
    for name, kw, cplx, dt, seed in LARGE_CASES:
        op = hubbard_op(tpkg, **kw)
        fn = sl.sharded_matvec_large_pair_flat if cplx \
            else sl.sharded_matvec_large_real_flat
        mv = fn(op, mesh, dtype=getattr(torch, dt), device="cpu")
        out[name] = mv(vector(op.dim, cplx, seed)).numpy()
    # the batched appliers (batch folded into the SpMM width) against the
    # one-vector ones
    for name, cplx in (("batched_real", False), ("batched_pair", True)):
        op = hubbard_op(tpkg, 2, 2, nbath=1, jh=0.3, complex_h=cplx)
        build = sl.build_sharded_large_pair if cplx \
            else sl.build_sharded_large_real
        dev = build(op, mesh, dtype=torch.float64, device="cpu")
        xb = sl.shard_rows(dev, torch.as_tensor(vector(op.dim, cplx, 20,
                                                        rows=3)))
        yb = sl.apply_sharded_large_real_flat_batched(dev, xb)
        ys = torch.stack([sl.apply_sharded_large_real_flat(dev, r)
                          for r in xb])
        out[name] = sl.gather_vector(dev, yb).numpy()
        out[name + "_single"] = sl.gather_vector(dev, ys).numpy()
    # the dense-factor sharded matvecs
    op = spmv_op(tpkg, realify=True)
    v = vector(op.dim, False, 11)
    for overlap in (0, 2):
        out[f"spmv_real_overlap{overlap}"] = ss.sharded_matvec_real_flat(
            op, mesh, overlap=overlap, device="cpu")(v).numpy()
    op = real_spmv_op(tpkg)
    out["spmv_real_jxjp"] = ss.sharded_matvec_real_flat(
        op, mesh, device="cpu")(vector(op.dim, False, 5)).numpy()
    op = spmv_op(tpkg, norb=2, nlat=1, nbath=3, nup=3, ndw=2, jx=0.25,
                 jp=0.15)
    out["spmv_pair_jxjp"] = ss.sharded_matvec_pair_flat(
        op, mesh, device="cpu")(vector(op.dim, True, 12)).numpy()
    # the eigensolvers over sharded vectors (every reduction summed over
    # the "dw" group): mixed complex, f64 real, and a GF chain
    op = hubbard_op(tpkg, 2, 2, nbath=1, complex_h=True)
    d32 = sl.build_sharded_large_pair(op, mesh, dtype=torch.float32,
                                      device="cpu")
    d64 = sl.build_sharded_large_pair(op, mesh, dtype=torch.float64,
                                      reuse=d32, device="cpu")
    v0 = sl.shard_rows(d64, vector(op.dim, True, 14))
    dim_loc = v0.shape[0]
    res = lanczos.eigh_mixed(
        sl.apply_sharded_large_real_flat, sl.apply_sharded_large_real_flat,
        dim_loc, neigen=2, ncv=30, maxiter=600, tol=1e-10, op32=d32,
        op64=d64, v0=v0, dtype=torch.complex64, device_vectors=True)
    out["mixed_pair_eigs"] = res.eigenvalues
    vecs = sl.gather_vector(d64, res.eigenvectors).numpy()
    out["mixed_pair_resid"] = float(np.linalg.norm(
        op.matvec_np(vecs[0]) - res.eigenvalues[0] * vecs[0]))
    op = hubbard_op(tpkg, 3, 3, nbath=2)
    d64 = sl.build_sharded_large_real(op, mesh, dtype=torch.float64,
                                      device="cpu")
    res = lanczos.eigh(
        sl.apply_sharded_large_real_flat, d64.diag.numel(), neigen=1,
        ncv=30, maxiter=600, tol=1e-12,
        v0=sl.shard_rows(d64, vector(op.dim, False, 15)), op=d64)
    out["real_eig"] = res.eigenvalues
    rows = sl.shard_rows(d64, torch.as_tensor(vector(op.dim, False, 16,
                                                     rows=2)))
    out["tridiag"] = lanczos.tridiag(
        sl.apply_sharded_large_real_flat_batched, rows, 12, op=d64)
    out["exchange_bytes"] = ss.exchange_bytes
    return out


# ---------------------------------------------------------------------------
# whole solves on a mesh (tests/test_sharded_spmv.py:111-152,
# tests/test_sector_parallel.py:117-153, tests/bhz_case.py)
# ---------------------------------------------------------------------------

def plaquette_solve(pkg, workdir, device=None):
    """The bath-less U=4 2x2 plaquette at lanc_dim_threshold=1."""
    h = np.zeros((4, 4, 1, 1, 1, 1), dtype=complex)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        h[i, j, 0, 0, 0, 0] = h[j, i, 0, 0, 0, 0] = -1.0
    cfg = pkg.EDConfig(nlat=4, norb=1, nspin=1, nbath=0, uloc=[4.0],
                       gf_flag=False, ed_verbose=0, lanc_dim_threshold=1,
                       work_dir=workdir)
    s = pkg.EDSolver(cfg, **(device or {}))
    s.init_solver()
    s.solve(np.zeros(0), h)
    return s


def pair_bath_solve(pkg, workdir, device=None, prec="complex128",
                    threshold=4):
    """2 sites + 1 bath (Ns=4), U=2.5: the real case of
    tests/test_sector_parallel.py:117-153, with same-bucket batches."""
    cfg = pkg.EDConfig(nlat=2, norb=1, nspin=1, nbath=1, uloc=[2.5],
                       lmats=16, lreal=8, lanc_dim_threshold=threshold,
                       ed_precision=prec, ed_verbose=0, work_dir=workdir)
    nn = (2, 2, 1, 1, 1, 1)
    hloc = np.zeros(nn, np.complex128)
    hloc[0, 1, 0, 0, 0, 0] = hloc[1, 0, 0, 0, 0, 0] = -1.0
    basis = np.zeros((1,) + nn, np.complex128)
    for il in range(2):
        basis[0, il, il, 0, 0, 0, 0] = 1.0
    s = pkg.EDSolver(cfg, **(device or {}))
    s.set_hbath(basis, np.array([[0.3]]))
    s.solve(s.init_solver(), hloc)
    return s


def bhz_solve(pkg, workdir, device=None, prec="complex128", threshold=16,
              jbath=None, jfields=None):
    """The complex Ns=6 case of tests/bhz_case.py; the port takes the JAX
    package's configuration fields and bath array (``jfields``,
    ``jbath``) through carry.state_from_numpy."""
    bhz = importlib.import_module(pkg.__name__ + ".models.bhz")
    _, basis, lams = bhz_case.model(bhz)
    hloc = bhz_case.lattice(bhz)[1]
    kw = dict(bhz_case.KW, ed_precision=prec,
              lanc_dim_threshold=threshold, work_dir=workdir)
    if jfields is None:
        s = pkg.EDSolver(pkg.EDConfig(**kw))
        s.set_hbath(basis, lams)
        bath = s.init_solver()
        s.solve(bath, hloc)
        return s, bath, dataclasses.asdict(s.cfg)
    from cdmft_lanc_ed_torch.carry import state_from_numpy
    cfg, hb, bath = state_from_numpy(dict(jfields, **kw), basis, lams,
                                     jbath, device="cpu")
    s = pkg.EDSolver(cfg, **(device or {}))
    s.hb = hb
    s.init_solver()
    s.solve(bath, hloc)
    return s


def results_of(s):
    """The numbers the mesh tests hold to the references."""
    out = {"egs": s.egs, "dens": np.asarray(s.dens())}
    if s.cfg.gf_flag:
        out["smats"] = np.asarray(s.sigma_matsubara())
        out["gmats"] = np.asarray(s.gimp_matsubara())
    return out


def mesh_solves(mesh, rank, cases, tmpdir, dense_max=None):
    """EDSolver with ``mesh`` installed, on each case of ``cases``
    [(name, solver function, kwargs)], with ``split.DENSE_FACTOR_MAX``
    lowered to ``dense_max`` when given; each rank writes its files in
    its own work directory.  Records the route of every Lanczos solve."""
    import os
    import cdmft_lanc_ed_torch as tpkg
    from cdmft_lanc_ed_torch import diag
    from cdmft_lanc_ed_torch.ops import split
    from cdmft_lanc_ed_torch.parallel import multichip
    if dense_max:
        split.DENSE_FACTOR_MAX = dense_max
    multichip.set_solver_mesh(mesh)
    routes = []
    serial, batched = diag._solve_sharded, diag._solve_batched

    def spy_sharded(cfg, op, *a):
        routes.append(("sharded", op.dim))
        return serial(cfg, op, *a)

    def spy_batched(cfg, members, *a):
        routes.append(("batched", len(members)))
        return batched(cfg, members, *a)

    diag._solve_sharded, diag._solve_batched = spy_sharded, spy_batched
    out = {}
    try:
        for name, fn, kw in cases:
            wd = os.path.join(tmpdir, f"{name}_rank{rank}")
            os.makedirs(wd, exist_ok=True)
            routes.clear()
            s = globals()[fn](tpkg, wd, device={"device": "cpu"}, **kw)
            out[name] = dict(results_of(s), routes=list(routes))
    finally:
        diag._solve_sharded, diag._solve_batched = serial, batched
    return out
