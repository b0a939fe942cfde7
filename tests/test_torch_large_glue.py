"""The large kits' H·v glue (``ops/glue.py``) around the two block-sparse
SpMMs: on the CPU the plain path, held bit for bit to the torch
expressions that ``ops/large.py`` ran before the card took the kernels of
``csrc/large_glue.cu``, and its index maps to their definition; on the
card (``cuda``-marked, skipped without CUDA) the kernels, held bit for bit
to the torch glue.

This file imports no JAX, so its card tests also run where JAX is
missing:

    python -m pytest tests/test_torch_large_glue.py -m cuda --noconftest -q

The sectors are tiny Ns=10 ones built on the large kits directly: (5,3),
so the dw side has 128 padded rows and the up side 256, with real tiles,
with Jx/Jp terms (two orbitals, Jh = 0.3) and with complex tiles.
"""
import numpy as np
import pytest
import torch

import cdmft_lanc_ed_torch as tpkg
from cdmft_lanc_ed_torch.ops import glue, large
from cdmft_lanc_ed_torch.ops import sector_ham as tsh
from cdmft_lanc_ed_torch.utils import timer

CASES = ("real", "jh", "complex")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (the suite runs in several worker processes at
    once)."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(nthreads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    return torch.device("cuda")


_OPS = {}


def _sector(case: str):
    """The (5,3) sector of an Ns=10 cluster with baths: two sites and four
    baths ("real"; "complex" with a complex hopping), or one site of two
    orbitals with Jh = Jx = Jp = 0.3 and four baths ("jh")."""
    if case not in _OPS:
        jh = 0.3 if case == "jh" else 0.0
        nlat, norb, nbath = (1, 2, 4) if jh else (2, 1, 4)
        cfg = tpkg.EDConfig(nlat=nlat, norb=norb, nspin=1, nbath=nbath,
                            uloc=[2.0] * norb, ust=0.5 if jh else 0.0,
                            jh=jh, jx=jh, jp=jh, ed_verbose=0)
        nn = (nlat, nlat, 1, 1, norb, norb)
        hloc = np.zeros(nn, np.complex128)
        for o in range(norb):
            hloc[0, 0, 0, 0, o, o] = 0.1 * o
            if nlat == 2:
                hloc[0, 1, 0, 0, o, o] = -1.0 + (0.3j if case == "complex"
                                                 else 0.0)
                hloc[1, 0, 0, 0, o, o] = np.conj(hloc[0, 1, 0, 0, o, o])
        hrec = np.zeros((nbath,) + nn, np.complex128)
        for b in range(nbath):
            for il in range(nlat):
                for o in range(norb):
                    hrec[b, il, il, 0, 0, o, o] = -0.6 + 0.4 * b
        dhyb = np.full((nlat, 1, norb, nbath), 0.45)
        op = tsh.build_sector_operator(cfg, hloc, hrec, dhyb, 5, 3)
        assert bool(op.nd_terms) == bool(jh)
        _OPS[case] = op
    return _OPS[case]


def _kit(case: str, dtype, device):
    """The large device operator of ``case`` with ``dtype`` tiles."""
    op = _sector(case)
    if case == "complex":
        return large.to_device_large_pair(op, dtype=dtype, device=device)
    return large.to_device_large_real(op, dtype=dtype, device=device)


def _torch_glue_matvec(op, x):
    """``large.matvec_large_real`` as it stood before the glue kernels."""
    out = op.diag * x
    out += large._dw(op, x)
    xt = x.T.contiguous()
    out += large._up(op, xt).T
    if op.nd_amp.shape[0]:
        out += large._nd_apply(x, xt, op)
    return out


def _torch_glue_batched(dev, x):
    """``large.apply_large_real_flat_batched`` as it stood before the glue
    kernels."""
    bb = x.shape[0]
    ddp, dup = dev.diag.shape
    x3 = x.reshape(bb, ddp, dup)
    out = dev.diag[None] * x3
    y = large._dw(dev, x3.permute(1, 2, 0).reshape(ddp, dup * bb))
    out += y.reshape(ddp, dup, bb).permute(2, 0, 1)
    del y
    y = large._up(dev, x3.permute(2, 1, 0).reshape(dup, ddp * bb))
    out += y.reshape(dup, ddp, bb).permute(2, 1, 0)
    del y
    if dev.nd_amp.shape[0]:
        for i in range(bb):
            out[i] += large._nd_apply(x3[i], x3[i].T, dev)
    return out.reshape(bb, -1)


def _vectors(dev, bb, dtype, seed):
    """bb random vectors of ``dtype`` on the operator's grid and device."""
    g = torch.Generator().manual_seed(seed)
    n = dev.diag.numel()
    x = torch.randn(bb, n, generator=g, dtype=torch.float64)
    if dtype.is_complex:
        x = torch.complex(x, torch.randn(bb, n, generator=g,
                                         dtype=torch.float64))
    return x.to(device=dev.diag.device, dtype=dtype)


def _index_maps(x3, y_dw, y_up, diag):
    """xt, xdw and out of their definitions, element by element."""
    bb, ddp, dup = x3.shape
    b, d, u = torch.meshgrid(torch.arange(bb), torch.arange(ddp),
                             torch.arange(dup), indexing="ij")
    xt = torch.empty(dup, ddp * bb, dtype=x3.dtype)
    xt[u, d * bb + b] = x3[b, d, u]
    xdw = torch.empty(ddp, dup * bb, dtype=x3.dtype)
    xdw[d, u * bb + b] = x3[b, d, u]
    out = diag[d, u] * x3[b, d, u] + y_dw[d, u * bb + b]
    return xt, xdw, out + y_up[u, d * bb + b]


# (case, complex vectors); complex tiles take complex vectors only
VECTORS = [("real", False), ("real", True), ("jh", False), ("jh", True),
           ("complex", True)]


@pytest.mark.parametrize("bb", [1, 3])
@pytest.mark.parametrize("case,cplx", VECTORS,
                         ids=[f"{c}-{'c' if v else 'r'}" for c, v in VECTORS])
def test_cpu_matvecs_bitwise_unchanged(case, cplx, bb):
    """The plain path gives the torch glue's H·v bit for bit, batched and
    one by one, and counts no fused glue and no launch."""
    cpu = torch.device("cpu")
    dev = _kit(case, torch.float64, cpu)
    x = _vectors(dev, bb, torch.complex128 if cplx else torch.float64,
                 seed=10 * bb + len(case))
    n0 = glue.launches
    rec = timer.Timers()
    with rec.active():
        got = large.apply_large_real_flat_batched(dev, x)
        rows = large.apply_large_real_flat(dev, x)
    assert torch.equal(got, _torch_glue_batched(dev, x))
    sh = tuple(dev.diag.shape)
    assert torch.equal(rows, torch.stack(
        [_torch_glue_matvec(dev, r.reshape(sh)).reshape(-1) for r in x]))
    assert rec.counters.get("large.fused_glue", 0) == 0
    assert glue.launches == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128],
                         ids=["f32", "f64", "c64", "c128"])
@pytest.mark.parametrize("bb", [1, 3])
def test_cpu_index_maps(dtype, bb):
    """pack and combine on CPU tensors are the maps of their definition,
    on a grid whose sides are no multiple of a tile."""
    g = torch.Generator().manual_seed(bb)
    ddp, dup = 37, 20
    rdt = torch.float64 if dtype in (torch.float64, torch.complex128) \
        else torch.float32

    def rnd(*shape):
        t = torch.randn(*shape, generator=g, dtype=torch.float64)
        if dtype.is_complex:
            t = torch.complex(t, torch.randn(*shape, generator=g,
                                             dtype=torch.float64))
        return t.to(dtype)

    x3 = rnd(bb, ddp, dup)
    y_dw, y_up = rnd(ddp, dup * bb), rnd(dup, ddp * bb)
    diag = torch.randn(ddp, dup, generator=g, dtype=torch.float64).to(rdt)
    xt, xdw = glue.pack(x3)
    w_xt, w_xdw, w_out = _index_maps(x3, y_dw, y_up, diag)
    assert xt.is_contiguous() and torch.equal(xt, w_xt)
    assert torch.equal(xdw, w_xdw)
    assert torch.equal(glue.combine(diag, x3, y_dw, y_up), w_out)


# ---------------------------------------------------------------------------
# on the card

GLUE_TYPES = [torch.float32, torch.float64, torch.complex64,
              torch.complex128]
GLUE_IDS = ["f32", "f64", "c64", "c128"]


def _operands(dtype, bb, ddp, dup, device, offset):
    """x3, y_dw, y_up and diag on ``device``, each ``offset`` elements
    into its buffer (offset 1 breaks the 16-byte alignment of the real
    types' rows)."""
    g = torch.Generator().manual_seed(1000 * bb + ddp + dup + offset)
    rdt = torch.float64 if dtype in (torch.float64, torch.complex128) \
        else torch.float32

    def rnd(dt, *shape):
        n = int(np.prod(shape))
        t = torch.randn(n + offset, generator=g, dtype=torch.float64)
        if dt.is_complex:
            t = torch.complex(t, torch.randn(n + offset, generator=g,
                                             dtype=torch.float64))
        return t.to(device=device, dtype=dt)[offset:].view(shape)

    return (rnd(dtype, bb, ddp, dup), rnd(dtype, ddp, dup * bb),
            rnd(dtype, dup, ddp * bb), rnd(rdt, ddp, dup))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", GLUE_TYPES, ids=GLUE_IDS)
@pytest.mark.parametrize("bb", [1, 3, 40])
@pytest.mark.parametrize("ddp,dup,offset", [(256, 128, 0), (100, 72, 0),
                                            (70, 33, 0), (256, 128, 1)])
def test_kernels_match_torch_glue(card, dtype, bb, ddp, dup, offset):
    """glue_pack and glue_combine equal the torch expressions bit for bit
    on the card (ddp != dup; ragged edge tiles; rows off the 16-byte
    grid), two launches."""
    x3, y_dw, y_up, diag = _operands(dtype, bb, ddp, dup, card, offset)
    n0 = glue.launches
    xt, xdw = glue.pack(x3)
    out = glue.combine(diag, x3, y_dw, y_up)
    torch.cuda.synchronize()
    assert glue.launches == n0 + 2
    w_xt, w_xdw = glue.pack_ref(x3)
    assert torch.equal(xt, w_xt) and torch.equal(xdw, w_xdw)
    assert torch.equal(out, glue.combine_ref(diag, x3, y_dw, y_up))


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("bb", [1, 3])
@pytest.mark.parametrize("case,cplx", VECTORS,
                         ids=[f"{c}-{'c' if v else 'r'}" for c, v in VECTORS])
def test_kernel_matvecs_match_torch_glue(card, case, cplx, bb, tdt):
    """The large kits' H·v on the card equals the torch glue's bit for
    bit (the same SpMM launches on both sides), takes exactly two SpMM
    launches and two glue launches, and counts ``large.fused_glue`` once
    an H·v."""
    dev = _kit(case, tdt, card)
    vdt = (torch.complex128 if tdt == torch.float64 else torch.complex64) \
        if cplx else tdt
    x = _vectors(dev, bb, vdt, seed=bb)
    spmm0, glue0 = large.launches, glue.launches
    rec = timer.Timers()
    with rec.active():
        got = large.apply_large_real_flat_batched(dev, x)
        rows = large.apply_large_real_flat(dev, x)
    torch.cuda.synchronize()
    assert large.launches == spmm0 + 2 * (1 + bb)
    assert glue.launches == glue0 + 2 * (1 + bb)
    assert rec.counters["large.fused_glue"] == 1 + bb
    assert torch.equal(got, _torch_glue_batched(dev, x))
    sh = tuple(dev.diag.shape)
    assert torch.equal(rows, torch.stack(
        [_torch_glue_matvec(dev, r.reshape(sh)).reshape(-1) for r in x]))


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(card):
    """A CUDA tensor the kernels do not take raises (no fallback)."""
    x3, y_dw, y_up, diag = _operands(torch.float64, 1, 64, 32, card, 0)
    with pytest.raises(TypeError):
        glue.pack(x3.to(torch.bfloat16))
    with pytest.raises(ValueError):
        glue.combine(diag.float(), x3, y_dw, y_up)
    with pytest.raises(ValueError):
        glue.combine(diag, x3, y_dw.T, y_up)
