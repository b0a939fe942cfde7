"""The GF chain step of ``ops/lanczos.tridiag``: on the CPU the plain
torch recurrence, held bitwise to its expressions as they stood before
the card took the kernel set of ``csrc/lanczos_chain.cu``; on the card
(``cuda``-marked, skipped without CUDA) the kernel set against the torch
path.

This file imports no JAX, so its card tests also run where JAX is
missing:

    python -m pytest tests/test_torch_chain_step.py -m cuda --noconftest -q

Tolerances on the card: f64 and complex128 chains agree with the plain
path to 1e-13 of the largest coefficient (the two sum in other orders;
12 steps of a well-separated spectrum amplify rounding little); f32 and
complex64 chains lie within twice the plain path's own distance (plus
1e-6) from the f64 chain of the same f32-rounded operator.
"""
import pathlib
import sys
import types
import uuid

import numpy as np
import pytest
import torch

from cdmft_lanc_ed_torch.ops import chain, lanczos
from cdmft_lanc_ed_torch.utils import timer

NITER = 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (the suite runs in several worker processes at
    once; the host arrays here are too small for numpy's BLAS to
    matter)."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(nthreads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    return torch.device("cuda")


def _problem(n, nrows, complex_, breakdown, seed=0):
    """A Hermitian H [n, n] (host) whose index ``n // 2`` is decoupled,
    so the unit vector there is an exact eigenvector, and ``nrows`` start
    rows [nrows, n] (host), the middle one that unit vector when
    ``breakdown`` (its chain breaks down after one step: beta = 0
    exactly, then zero vectors)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    if complex_:
        a = a + 1j * rng.normal(size=(n, n))
    h = (a + a.conj().T) / 2 + np.diag(np.arange(n) * 0.5)
    k = n // 2
    h[k, :] = 0.0
    h[:, k] = 0.0
    h[k, k] = 1.25
    v0 = rng.normal(size=(nrows, n))
    if complex_:
        v0 = v0 + 1j * rng.normal(size=(nrows, n))
    if breakdown:
        v0[nrows // 2] = 0.0
        v0[nrows // 2, k] = 2.0
    return h, v0


def _dense(h, device, dtype):
    """(apply_fn, op) of the dense H on ``device`` in ``dtype``."""
    ht = torch.as_tensor(h.T.copy()).to(device=device, dtype=dtype)
    op = types.SimpleNamespace(diag=torch.zeros(1, device=device))
    return (lambda _op, x: x @ ht), op


def _tridiag(h, v0, device, dtype, niter=NITER):
    apply_fn, op = _dense(h, device, dtype)
    return lanczos.tridiag(apply_fn, v0, niter, op, dtype=dtype)


def _tridiag_before(apply_fn, v0, niter, op, dtype):
    """The chain as ``tridiag`` ran it on every device before the kernel
    set (unsharded, host start rows): the plain path must stay this."""
    device = op.diag.device
    v0 = np.asarray(v0)
    norms0 = np.linalg.norm(v0, axis=1)
    scale = np.where(norms0 > 1e-300, norms0, 1.0)
    v = torch.as_tensor(np.ascontiguousarray(v0 / scale[:, None])).to(
        device=device, dtype=dtype)
    nb = v.shape[0]
    rdtype = torch.float64 if dtype in (torch.float64, torch.complex128) \
        else torch.float32
    p = torch.zeros_like(v)
    beta_prev = torch.zeros(nb, dtype=rdtype, device=device)
    alphas = torch.empty(niter, nb, dtype=rdtype, device=device)
    betas = torch.empty(niter, nb, dtype=rdtype, device=device)
    for it in range(niter):
        w = apply_fn(op, v)
        alpha = (v.conj() * w).sum(dim=1).real
        w = w - alpha[:, None] * v - beta_prev[:, None] * p
        beta = torch.linalg.vector_norm(w, dim=1)
        good = (beta > 1e-200)[:, None]
        nxt = torch.where(good, w / beta.clamp_min(1e-300)[:, None],
                          torch.zeros_like(w))
        p, v, beta_prev = v, nxt, beta
        alphas[it] = alpha
        betas[it] = beta
    return (alphas.T.numpy(), betas.T.numpy()[:, : niter - 1], norms0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128],
                         ids=["f64", "c128"])
@pytest.mark.parametrize("nrows,breakdown", [(1, False), (1, True),
                                             (3, True)])
def test_cpu_path_bitwise_unchanged(dtype, nrows, breakdown):
    """The CPU path gives today's alphas, betas and norms bit for bit, a
    broken-down row included (beta 0, then a chain of zero vectors), and
    counts its steps with no fused ones."""
    h, v0 = _problem(37, nrows, dtype.is_complex, breakdown)
    if not dtype.is_complex:
        v0 = v0.real
    rec = timer.Timers()
    with rec.active():
        got = _tridiag(h, v0, torch.device("cpu"), dtype)
    apply_fn, op = _dense(h, torch.device("cpu"), dtype)
    want = _tridiag_before(apply_fn, v0, NITER, op, dtype)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if breakdown:
        k = nrows // 2
        assert got[1][k, 0] == 0.0
        np.testing.assert_array_equal(got[0][k, 1:], 0.0)
        np.testing.assert_array_equal(got[1][k], 0.0)
    assert rec.counters["gf.steps"] == NITER
    assert rec.counters.get("gf.fused_steps", 0) == 0


def test_cpu_path_device_rows_match_host_rows():
    """Start rows given as a tensor (the large-sector injections) take
    the same plain path as host rows."""
    h, v0 = _problem(37, 3, False, True, seed=3)
    host = _tridiag(h, v0, torch.device("cpu"), torch.float64)
    dev = _tridiag(h, torch.as_tensor(v0), torch.device("cpu"),
                   torch.float64)
    for a, b in zip(host, dev):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=1e-14)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


_HI = {torch.float32: torch.float64, torch.complex64: torch.complex128}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128,
                                   torch.float32, torch.complex64],
                         ids=["f64", "c128", "f32", "c64"])
@pytest.mark.parametrize("n,nrows", [(37, 1), (37, 3), (1001, 3),
                                     (100003, 2)])
def test_kernel_chain_matches_torch_path(card, dtype, n, nrows):
    """The fused chain on the card against the plain torch path on the
    CPU, at lengths that are not multiples of a 16-byte pack (rows
    misaligned past the first), with a broken-down row where B > 1;
    every step took the kernels (``gf.fused_steps == gf.steps``, three
    launches a step).  f64 and complex128 to 1e-13; in f32 and complex64
    both versions round at f32 (the torch path's sums, too), so each is
    held to the f64 chain of the same f32-rounded operator, and the
    kernels (f64 sums, fused updates) to at most twice the torch path's
    error."""
    if n < 2000:
        h, v0 = _problem(n, nrows, dtype.is_complex, nrows > 1, seed=n)

        def make(device, dt, op_dt):
            return _dense(torch.as_tensor(h).to(op_dt).numpy(), device, dt)
    else:
        # a long chain: H = a random diagonal + a ring hopping
        rng = np.random.default_rng(n)
        d = rng.normal(size=n)
        v0 = rng.normal(size=(nrows, n))
        if dtype.is_complex:
            v0 = v0 + 1j * rng.normal(size=(nrows, n))

        def make(device, dt, op_dt):
            dd = torch.as_tensor(d).to(op_dt).to(device=device, dtype=dt)

            def apply_fn(_op, x):
                return dd * x + 0.5 * (torch.roll(x, 1, 1)
                                       + torch.roll(x, -1, 1))
            return apply_fn, types.SimpleNamespace(
                diag=torch.zeros(1, device=device))
    if not dtype.is_complex:
        v0 = v0.real
    tri = lanczos.tridiag
    rec = timer.Timers()
    n0 = chain.launches
    apply_fn, op = make(card, dtype, dtype)
    with rec.active():
        got = tri(apply_fn, v0, NITER, op, dtype=dtype)
    torch.cuda.synchronize()
    apply_fn, op = make(torch.device("cpu"), dtype, dtype)
    want = tri(apply_fn, v0, NITER, op, dtype=dtype)
    assert chain.launches == n0 + 3 * NITER
    assert rec.counters["gf.fused_steps"] == rec.counters["gf.steps"] \
        == NITER
    if dtype in _HI:
        apply_fn, op = make(torch.device("cpu"), _HI[dtype], dtype)
        ref = tri(apply_fn, v0, NITER, op, dtype=_HI[dtype])
    for k in range(2):
        assert np.isfinite(got[k]).all()
        if dtype in _HI:
            assert _rel(got[k], ref[k]) <= 2 * _rel(want[k], ref[k]) + 1e-6
        else:
            assert _rel(got[k], want[k]) <= 1e-13
    np.testing.assert_allclose(got[2], want[2], rtol=1e-14)
    if nrows > 1 and n < 2000:
        k = nrows // 2
        assert got[1][k, 0] == 0.0
        np.testing.assert_array_equal(got[0][k, 1:], 0.0)


@pytest.mark.cuda
def test_kernel_chain_is_deterministic(card):
    """Two runs of one chain give the same bits (no float atomics)."""
    h, v0 = _problem(1001, 3, False, False, seed=5)
    a = _tridiag(h, v0, card, torch.float64)
    b = _tridiag(h, v0, card, torch.float64)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 0, 0), (0, 1, 1)])
def test_kernel_steps_on_misaligned_operands(card, dtype, shift):
    """The three launches on operands that start at other places within
    16 bytes (views one element into a buffer: the one-element path)
    against the plain expressions, first step (no p) and later."""
    rng = np.random.default_rng(7)
    nrows, n = 3, 1003

    def vec(s):
        buf = torch.as_tensor(rng.normal(size=nrows * n + 1)).to(
            device=card, dtype=dtype)
        return buf[s:s + nrows * n].view(nrows, n)
    v, w, p = (vec(s) for s in shift)
    alpha = torch.empty(nrows, dtype=dtype, device=card)
    beta_prev = torch.as_tensor(rng.normal(size=nrows)).to(card, dtype)
    beta = torch.empty(nrows, dtype=dtype, device=card)
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    ch = chain.Chain(v)
    for first in (True, False):
        w0 = vec(shift[1])
        w0.copy_(w)
        ch.dot(v, w0, alpha)
        a_ref = (v.double() * w.double()).sum(1)
        assert _rel(alpha.double().cpu().numpy(), a_ref.cpu().numpy()) <= tol
        ch.update(w0, v, None if first else p, alpha,
                  None if first else beta_prev)
        upd = w.double() - alpha.double()[:, None] * v.double()
        if not first:
            upd = upd - beta_prev.double()[:, None] * p.double()
        assert _rel(w0.double().cpu().numpy(), upd.cpu().numpy()) <= tol
        ch.scale(w0, beta)
        nrm = torch.linalg.vector_norm(upd, dim=1)
        assert _rel(beta.double().cpu().numpy(), nrm.cpu().numpy()) <= tol
        assert _rel(w0.double().cpu().numpy(),
                    (upd / nrm[:, None]).cpu().numpy()) <= tol


def _sharded_child(rank, world, store_path, out_path, v0, h):
    """One rank of a chain sharded by columns of the vectors over a gloo
    group, its vectors on the card: H·v gathers the whole vectors (on
    the host) and keeps this rank's rows of H·v."""
    import torch.distributed as dist
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        dev = torch.device("cuda")
        n = h.shape[0]
        lo, hi = rank * n // world, (rank + 1) * n // world
        hrows = torch.as_tensor(h[lo:hi].T.copy()).to(dev)

        def apply_fn(_op, x):
            parts = [torch.empty(x.shape[0], (r + 1) * n // world
                                 - r * n // world, dtype=x.dtype)
                     for r in range(world)]
            dist.all_gather(parts, x.cpu())
            return (torch.cat(parts, 1).to(dev) @ hrows).contiguous()
        op = types.SimpleNamespace(diag=torch.zeros(1, device=dev),
                                   group=dist.group.WORLD)
        rec = timer.Timers()
        with rec.active():
            out = lanczos.tridiag(apply_fn, v0[:, lo:hi], NITER, op)
        torch.save((out, rec.counters), f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_kernel_chain_sharded_over_two_ranks(card, tmp_path):
    """A chain whose vectors two gloo ranks share (each holding columns)
    sums alpha and the norm over the ranks between the launches: both
    ranks give the unsharded chain's coefficients."""
    import torch.multiprocessing as tmp
    h, v0 = _problem(200, 2, False, False, seed=9)
    here = pathlib.Path(__file__).resolve().parent
    saved = list(sys.path)
    sys.path[:0] = [str(here.parent), str(here)]
    out = str(tmp_path / "sharded")
    try:
        tmp.spawn(_sharded_child,
                  args=(2, str(tmp_path / f"store_{uuid.uuid4().hex}"),
                        out, v0, h), nprocs=2, join=True)
    finally:
        sys.path[:] = saved
    want = _tridiag(h, v0, torch.device("cpu"), torch.float64)
    for r in range(2):
        got, counters = torch.load(f"{out}.{r}", weights_only=False)
        assert counters["gf.fused_steps"] == counters["gf.steps"] == NITER
        for g, w in zip(got[:2], want[:2]):
            assert _rel(g, w) <= 1e-13
        np.testing.assert_allclose(got[2], want[2], rtol=1e-14)
