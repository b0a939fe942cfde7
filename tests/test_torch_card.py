"""The CUDA kernel of the port on the card: it builds from csrc/, launches
(counted) and agrees with its plain version.  Skips without CUDA.

This file imports no JAX, so it also runs where JAX is missing:

    python -m pytest tests/test_torch_card.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from cdmft_lanc_ed_torch.ops import fused, split


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,u", [(0, 1024, 1024), (3, 924, 924),
                                   (0, 66, 220), (2, 1, 12)])
def test_kernel_matches_plain(card, b, d, u):
    rng = np.random.default_rng(11)
    lead = (b,) if b else ()

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=card)

    args = (t(*lead, d, u), t(*lead, d, d), t(*lead, u, u), t(*lead, d, u))
    n0 = fused.launches
    out = fused.fused_real_matvec(*args)
    torch.cuda.synchronize()
    assert fused.launches == n0 + 1
    ref = fused.fused_real_matvec_ref(*args)
    assert float((out - ref).abs().max()) <= 2e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_shared_operator_and_f32_dispatch(card):
    rng = np.random.default_rng(12)
    d, u = 70, 56
    op = split.DenseRealOp(
        diag=torch.as_tensor(rng.normal(size=(d, u)), device=card),
        hdw=torch.as_tensor(rng.normal(size=(d, d)), device=card),
        hupT=torch.as_tensor(rng.normal(size=(u, u)), device=card),
        nd_amp=torch.zeros(0, device=card, dtype=torch.float64),
        nd_upT=torch.zeros(0, u, u, device=card, dtype=torch.float64),
        nd_dw=torch.zeros(0, d, d, device=card, dtype=torch.float64))
    op32 = split.DenseRealOp(**{k: v.float() for k, v in vars(op).items()})
    x = torch.as_tensor(rng.normal(size=(5, d * u)), device=card)
    n0 = fused.launches
    y32 = split.apply_real_flat(op32, x.float())
    assert fused.launches == n0 + 1
    y64 = split.apply_real_flat(op, x)
    assert fused.launches == n0 + 1
    assert float((y32.double() - y64).abs().max()) \
        <= 2e-4 * float(y64.abs().max())
