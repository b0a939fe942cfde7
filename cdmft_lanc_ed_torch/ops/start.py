"""The seeded start vector of a large sector: drawn in parallel, bit for
bit, straight into the kit's padded rows, and normalised on the device.

The eigensolvers start from ``default_rng(8527).normal(size=dim)``, as the
JAX package does (a complex sector: re, then im).  At Ns=16 that is 1.66e8
samples, ~4 s of one host thread while the card waits.  NumPy's normals
come from a ziggurat on PCG64: most samples take one 64-bit word,
rejections take more, so a copy of the generator advanced by j·C raw words
(``PCG64.advance``) parses the same word stream from a point a sample or
two off the true one and then runs in step with it.  :func:`normals`
draws T such segments at once (NumPy releases the interpreter lock while
it fills) and cuts each one where its first samples recur in the previous
segment's tail, a merge confirmed by a run of ``_RUN`` equal samples.
Where no merge is found the rest is drawn serially from the last good
segment (exact, and counted).  The last segment ends short of the count
and is finished serially, so the caller's generator ends where the serial
draw leaves it.

:func:`padded` puts sample k at row k // du, column k % du of the kit's
[ddp, dup] rows (padding zero) in a pinned host buffer on the card;
:func:`unit_rows` takes its ``np.linalg.norm``, as ``lanczos._unit`` does,
and divides on the device in f64: the same IEEE quotient (a complex
vector: the product with 1/norm that NumPy's complex division forms).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils.timer import count

# draws of this many samples or more take the parallel path
PARALLEL_FROM = 1 << 22
# raw 64-bit words NumPy's ziggurat takes per normal, on average
_WORDS = 1.022
# head samples of a segment tried against the previous one's tail
_HEAD = 64
# equal samples that confirm a merge
_RUN = 16
# fewest samples a segment draws
_MIN_SEGMENT = 8192


def threads() -> int:
    """Drawing threads: the CPUs this process may run on, at most 32."""
    return min(32, len(os.sched_getaffinity(0)))


def _segment(state: dict, skip: int, size: int):
    """A generator at PCG64 ``state`` advanced by ``skip`` raw words, and
    the ``size`` normals it draws next."""
    bg = np.random.PCG64()
    bg.state = state
    if skip:
        bg.advance(skip)
    g = np.random.Generator(bg)
    return g, g.standard_normal(size)


def _merge(prev: np.ndarray, cur: np.ndarray, lo: int):
    """(i, p): the first head sample i of ``cur`` whose run of ``_RUN``
    samples recurs in ``prev`` at p >= ``lo``; None if none does."""
    for i in range(min(_HEAD, len(cur) - _RUN)):
        hits = np.flatnonzero(prev[lo:len(prev) - _RUN + 1] == cur[i]) + lo
        for p in hits:
            if np.array_equal(prev[p:p + _RUN], cur[i:i + _RUN]):
                return i, int(p)
    return None


def normals(rng: np.random.Generator, n: int, put=None, *,
            nthreads: int | None = None):
    """``rng.normal(size=n)``, bit for bit, leaving ``rng`` where that call
    leaves it.  From ``PARALLEL_FROM`` samples of a PCG64 generator the
    draw is split over :func:`threads` threads (``nthreads``).  With
    ``put``, samples [lo, lo + len(x)) go to ``put(lo, x)`` (called from
    several threads at once, on disjoint ranges) and nothing is returned;
    else the samples come back as one array."""
    t = 0 if n < PARALLEL_FROM else min(nthreads or threads(),
                                        n // _MIN_SEGMENT)
    if t < 2 or not isinstance(rng.bit_generator, np.random.PCG64):
        x = rng.normal(size=n)
        if put is None:
            return x
        put(0, x)
        return None
    out = None
    if put is None:
        out = np.empty(n)

        def put(lo, x):
            out[lo:lo + len(x)] = x
    count("diag.start.parallel")
    state = rng.bit_generator.state
    c = int(n * _WORDS / t)                 # raw words between segments
    size = int(1.03 * c) + 4096             # passes the next start by 3%
    last = n - (4096 + n // 500) - int((t - 1) * c / _WORDS)
    lo = max(_HEAD, int(0.9 * c / _WORDS) - 4096)
    with ThreadPoolExecutor(t) as ex:
        segs = list(ex.map(lambda j: _segment(
            state, j * c, size if j < t - 1 else last), range(t)))
        cuts = list(ex.map(lambda j: _merge(segs[j - 1][1], segs[j][1], lo),
                           range(1, t)))
        # walk the merges: segment j holds samples [o, o + len - a) of the
        # draw from its sample a; stop before a segment that does not
        # merge or would run past n
        parts, o, a, j = [], 0, 0, 0
        while j + 1 < t and cuts[j] is not None:
            i, p = cuts[j]
            if o + p - a + len(segs[j + 1][1]) - i > n:
                break
            parts.append((segs[j][1], a, p, o))
            o, a, j = o + p - a, i, j + 1
        if j + 1 < t:
            count("diag.start.stitch_fallbacks")
        g, x = segs[j]
        parts.append((x, a, len(x), o))
        o += len(x) - a
        parts.append((g.standard_normal(n - o), 0, n - o, o))
        for f in [ex.submit(put, at, x[a:b]) for x, a, b, at in parts]:
            f.result()
    end = g.bit_generator.state
    end["has_uint32"], end["uinteger"] = state["has_uint32"], \
        state["uinteger"]
    rng.bit_generator.state = end
    return out


def _put_rows(grid: np.ndarray, du: int, lo: int, x: np.ndarray) -> None:
    """Samples [lo, lo + len(x)) into ``grid`` [rows, >= du]: sample k at
    row k // du, column k % du."""
    r, col = divmod(lo, du)
    k = 0
    if col:
        k = min(du - col, len(x))
        grid[r, col:col + k] = x[:k]
        r += 1
    m = (len(x) - k) // du
    grid[r:r + m, :du] = x[k:k + m * du].reshape(m, du)
    k += m * du
    if k < len(x):
        grid[r + m, :len(x) - k] = x[k:]


def padded(rng: np.random.Generator, real: bool, dd: int, du: int,
           ddp: int, dup: int, device: torch.device,
           **kw) -> torch.Tensor:
    """The start vector that ``rng`` draws for a (dd, du) sector (real
    part, then for a complex one the imaginary part, each by
    :func:`normals`; ``kw`` goes there) in the kit's padded [ddp, dup]
    layout, zero in the padding: a flat float64 host tensor (a complex
    vector as interleaved (re, im) pairs), pinned when ``device`` is
    CUDA."""
    planes = 1 if real else 2
    with ThreadPoolExecutor(1) as ex:
        # a first pinned buffer of this size (~0.4 s to pin at Ns=16, once
        # a process) is allocated while the threads draw
        pending = ex.submit(torch.empty, ddp * dup * planes,
                            dtype=torch.float64,
                            pin_memory=device.type == "cuda")

        def put(lo, x, q):
            grid = pending.result().numpy().reshape(ddp, dup, planes)
            _put_rows(grid[..., q], du, lo, x)
        for q in range(planes):
            normals(rng, dd * du, lambda lo, x, q=q: put(lo, x, q), **kw)
        buf = pending.result()
    grid = buf.numpy().reshape(ddp, dup, planes)
    grid[:dd, du:] = 0.0
    grid[dd:] = 0.0
    return buf


def unit_rows(buf: torch.Tensor, real: bool,
              device: torch.device) -> torch.Tensor:
    """``buf`` (from :func:`padded`) over its norm, on ``device``, as
    ``lanczos._unit`` forms it on the host: ``np.linalg.norm`` of the
    padded vector, then each entry divided by it (a real vector) or
    multiplied by its reciprocal (what NumPy's complex division does), in
    f64.  One row [1, ddp * dup], float64 or complex128."""
    host = buf.numpy() if real else buf.numpy().view(np.complex128)
    nrm = float(np.linalg.norm(host))
    rows = buf.to(device)
    # a device tensor, not a Python number: CUDA's division by a host
    # scalar multiplies by its reciprocal
    if real:
        rows.div_(torch.full((), nrm, dtype=torch.float64, device=device))
        return rows[None]
    rows.mul_(torch.full((), 1.0 / nrm, dtype=torch.float64, device=device))
    return torch.view_as_complex(rows.view(-1, 2))[None]
