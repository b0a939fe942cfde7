"""The seeded start vector of a large sector (``ops/start.py``): the
parallel draw is ``default_rng(seed).normal(size=n)`` bit for bit and
leaves the generator where that call does, also where a merge fails or
the words-per-sample estimate is off; the padded rows are
``split.embed_real`` of the serial draw and the unit rows
``lanczos._unit`` of those, each ``np.array_equal`` / ``torch.equal``;
an eigensolve started from them on the CPU is the one started from the
host rows.  ``start.PARALLEL_FROM`` is lowered so that small sizes take
the parallel path.

On the card (``cuda``-marked, skipped without CUDA) the Ns=16 (8,8)
shape: the first Krylov basis column made the new way equals the one the
host path gives, in every Krylov dtype.  This file imports no JAX:

    python -m pytest tests/test_torch_seeded_normals.py -m cuda --noconftest -q
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_torch import diag, kit
from cdmft_lanc_ed_torch.ops import lanczos, split, start
from cdmft_lanc_ed_torch.utils import timer

CPU = torch.device("cpu")
SEEDS = (8527, 2**31 + 977, 3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (several test workers share the cores); the
    drawing threads are the code under test."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(nthreads)


@pytest.fixture
def low(monkeypatch):
    """Small draws take the parallel path."""
    monkeypatch.setattr(start, "PARALLEL_FROM", 1000)


def _draw(seed, n, nthreads):
    """normals() from ``default_rng(seed)``: (samples, generator after,
    counters)."""
    rng = np.random.default_rng(seed)
    rec = timer.Timers()
    with rec.active():
        x = start.normals(rng, n, nthreads=nthreads)
    return x, rng, rec.counters


def _serial(seed, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n), rng


def _serial_start(n, real, seed=8527):
    """The serial draw of a start vector: re, then im."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=n) if real else \
        rng.normal(size=n) + 1j * rng.normal(size=n)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,nthreads", [(200_000, 16), (131_079, 3),
                                        (50_000, 6), (16_384, 2)])
def test_parallel_draw_is_the_serial_draw(low, seed, n, nthreads):
    x, rng, counters = _draw(seed, n, nthreads)
    ref, ref_rng = _serial(seed, n)
    assert np.array_equal(x, ref)
    assert rng.bit_generator.state == ref_rng.bit_generator.state
    assert np.array_equal(rng.normal(size=7), ref_rng.normal(size=7))
    assert counters == {"diag.start.parallel": 1}


def test_below_the_threshold_nothing_changes():
    rng = np.random.default_rng(8527)
    rec = timer.Timers()
    with rec.active():
        x = start.normals(rng, 100_000, nthreads=8)
    ref, ref_rng = _serial(8527, 100_000)
    assert np.array_equal(x, ref)
    assert rng.bit_generator.state == ref_rng.bit_generator.state
    assert rec.counters == {}


@pytest.mark.parametrize("seed", SEEDS)
def test_complex_draw_re_then_im(low, seed):
    n = 90_000
    got = diag._start(n, False, np.random.default_rng(seed))
    assert np.array_equal(got, _serial_start(n, False, seed))


def test_shared_generator_across_members(low):
    """``_solve_batched`` draws its members from one generator: each
    member's draw starts where the last one ended."""
    sizes = (30_000, 777, 52_000, 20_000)
    rng = np.random.default_rng(8527)
    got = [diag._start(n, n % 2 == 0, rng) for n in sizes]
    ref_rng = np.random.default_rng(8527)
    ref = [ref_rng.normal(size=n) if n % 2 == 0 else
           ref_rng.normal(size=n) + 1j * ref_rng.normal(size=n)
           for n in sizes]
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert rng.bit_generator.state == ref_rng.bit_generator.state


@pytest.mark.parametrize("fail_at", [1, 4, 11])
def test_forced_fallback_is_exact_and_counted(low, monkeypatch, fail_at):
    """No merge at boundary ``fail_at``: the rest is drawn serially from
    the segment before it."""
    merge = start._merge
    n, t = 200_000, 16
    # the first sample of segment ``fail_at``, which names the boundary
    head = start._segment(np.random.default_rng(8527).bit_generator.state,
                          fail_at * int(n * start._WORDS / t), 1)[1][0]

    def failing(prev, cur, lo):
        return None if cur[0] == head else merge(prev, cur, lo)
    monkeypatch.setattr(start, "_merge", failing)
    x, rng, counters = _draw(8527, n, t)
    ref, ref_rng = _serial(8527, 200_000)
    assert np.array_equal(x, ref)
    assert rng.bit_generator.state == ref_rng.bit_generator.state
    assert counters == {"diag.start.parallel": 1,
                        "diag.start.stitch_fallbacks": 1}


@pytest.mark.parametrize("words,fallback", [(0.9, False), (1.2, True)])
def test_wrong_words_per_sample(low, monkeypatch, words, fallback):
    """Segments placed by a wrong rate: too low leaves a longer serial
    tail; too high would run the last segments past n, which are
    dropped (a counted fallback).  Both stay exact."""
    monkeypatch.setattr(start, "_WORDS", words)
    x, rng, counters = _draw(2**31 + 977, 200_000, 16)
    ref, ref_rng = _serial(2**31 + 977, 200_000)
    assert np.array_equal(x, ref)
    assert rng.bit_generator.state == ref_rng.bit_generator.state
    assert ("diag.start.stitch_fallbacks" in counters) == fallback


# (dd, du, ddp, dup): ragged padding, and none
LAYOUTS = [(300, 700, 320, 768), (210, 252, 256, 256), (128, 256, 128, 256)]


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_padded_rows(low, real, layout):
    dd, du, ddp, dup = layout
    rec = timer.Timers()
    with rec.active():
        buf = start.padded(np.random.default_rng(8527), real, *layout, CPU,
                           nthreads=5)
    got = buf.numpy() if real else buf.numpy().view(np.complex128)
    ref = split.embed_real(_serial_start(dd * du, real), *layout)
    assert np.array_equal(got, ref)
    assert rec.counters == {"diag.start.parallel": 1 if real else 2}


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_unit_rows(low, real, layout):
    dd, du, ddp, dup = layout
    rows = start.unit_rows(start.padded(np.random.default_rng(8527), real,
                                        *layout, CPU), real, CPU)
    ref = lanczos._unit(split.embed_real(_serial_start(dd * du, real),
                                         *layout))
    assert rows.dtype == (torch.float64 if real else torch.complex128)
    assert torch.equal(rows, torch.as_tensor(ref))


@pytest.mark.parametrize("tiles", [False, True])
def test_eigensolve_from_device_rows(monkeypatch, tiles):
    """A mixed eigensolve of an Ns=10 sector (dim 25,200) from the
    DeviceRows start equals the one from the host rows, on the dense kit
    and on the tile kit with its bf16 coarse stage."""
    import torch_dist_case as case   # imports threadpoolctl: not at the top
    if tiles:
        monkeypatch.setattr(split, "DENSE_FACTOR_MAX", 100)
    op = case.hubbard_op(tpkg, 4, 3, nbath=4)
    assert kit.is_large(op) == tiles
    cfg = tpkg.EDConfig(nlat=2, norb=1, nspin=1, nbath=4, uloc=[2.0],
                        ed_verbose=0, ed_precision="mixed")

    def solve():
        rec = timer.Timers()
        with rec.active():
            res, _ = diag._eigensolve(cfg, op, CPU, 1, 12, 240,
                                      start_span="diag.large.start")
        return res, rec
    ref, ref_rec = solve()
    monkeypatch.setattr(start, "PARALLEL_FROM", 1000)
    res, rec = solve()
    assert np.array_equal(res.eigenvalues, ref.eigenvalues)
    assert torch.equal(res.eigenvectors, ref.eigenvectors)
    assert res.iterations == ref.iterations
    assert rec.counters["diag.start.parallel"] == 1
    assert "diag.start.parallel" not in ref_rec.counters
    assert rec.counts["diag.large.start"] == 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
def test_first_column_on_the_card(card, dtype):
    """The Ns=16 (8,8) sector's rows (dd = du = 12,870, padded 12,928):
    the first basis column from ``diag._start_rows`` equals the host
    path's (serial draw, ``embed_real``, ``lanczos._unit``, the upload
    and cast of ``_thick_restart``)."""
    real = not dtype.is_complex
    dd = du = 12_870
    layout = (dd, du, 12_928, 12_928)
    k = kit.Kit(SimpleNamespace(diag=torch.empty(0, device=card)), None,
                real, dtype, 12_928**2, None, None, layout=layout)
    v0 = diag._start_rows(SimpleNamespace(dim=dd * du), k)
    assert isinstance(v0, lanczos.DeviceRows)
    rec = timer.Timers()
    with rec.active():
        col = lanczos._first_column(v0, card, dtype)
    assert rec.counters == {"diag.start.parallel": 1 if real else 2}
    ref = lanczos._first_column(lanczos._unit(split.embed_real(
        _serial_start(dd * du, real), *layout)), card, dtype)
    assert col.shape == (1, 12_928**2)
    assert torch.equal(col, ref)
