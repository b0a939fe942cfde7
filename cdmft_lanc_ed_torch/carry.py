"""What a CDMFT run carries across: the configuration, the bath basis and
the bath.  There are no weights.

:func:`state_from_numpy` builds the port's state from plain numpy inputs,
so that a caller holding the JAX package's state passes
``dataclasses.asdict(jax_cfg)`` and its arrays without the port importing
anything of that package.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bath as bath_mod
from .bath import BathBasis
from .config import EDConfig
from .device import resolve_device


def state_from_numpy(cfg_fields: dict, hsym_basis, hsym_lambdas,
                     bath_array, device=None):
    """(EDConfig, BathBasis, packed bath) from numpy inputs.

    ``cfg_fields``: EDConfig field values (e.g. ``dataclasses.asdict`` of
    a config); ``hsym_basis``/``hsym_lambdas``: the ``set_hbath`` inputs;
    ``bath_array``: a flat bath array in the reference layout.  The packed
    bath comes back as a float64 tensor on ``device`` (``None`` is the
    card), re-packed from its parsed form, so a malformed array raises
    here rather than mid-loop."""
    device = resolve_device(device)
    cfg = EDConfig(**cfg_fields).validate()
    hb: BathBasis = bath_mod.set_hbath(hsym_basis, hsym_lambdas, cfg)
    if not bath_mod.check_bath_dimension(cfg, hb.nsym, bath_array):
        raise ValueError("wrong bath dimensions")
    packed = bath_mod.pack_dmft_bath(
        cfg, bath_mod.unpack_dmft_bath(cfg, np.asarray(bath_array)))
    return cfg, hb, torch.as_tensor(packed, dtype=torch.float64,
                                    device=device)
