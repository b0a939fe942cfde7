"""Postprocessing: quasiparticle weight and scattering rate.

Port of the two functions of the JAX package's ``postprocess.py`` that the
solver's print stage needs (``io.write_zeta_and_sig``; the reference's
ED_GREENS_FUNCTIONS.f90:114-127): host numpy on the self-energy.  Band
structures and topological invariants are not ported yet.
"""
from __future__ import annotations

import numpy as np

from .config import EDConfig
from .utils.reshape import nnn2lso


def quasiparticle_weight(cfg: EDConfig, smats_nnn: np.ndarray) -> np.ndarray:
    """Z_a = [1 - Im Sigma_aa(i w_0)/w_0]^{-1} per diagonal lso component."""
    w0 = np.pi / cfg.beta
    s0 = nnn2lso(smats_nnn[..., 0], cfg.nlat, cfg.nspin, cfg.norb)
    return 1.0 / (1.0 - np.imag(np.diag(s0)) / w0)


def scattering_rate(cfg: EDConfig, smats_nnn: np.ndarray) -> np.ndarray:
    """Low-frequency extrapolation of -Im Sigma(i w -> 0) per component
    (from the first two Matsubara points, reference 'sig' files)."""
    w = np.pi / cfg.beta * np.array([1.0, 3.0])
    s = nnn2lso(smats_nnn[..., :2], cfg.nlat, cfg.nspin, cfg.norb)
    i1 = np.imag(np.diagonal(s[..., 0]))
    i2 = np.imag(np.diagonal(s[..., 1]))
    # linear extrapolation to w=0
    return -(i1 - (i2 - i1) / (w[1] - w[0]) * w[0])
