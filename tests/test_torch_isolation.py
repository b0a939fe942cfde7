"""The port stands alone: importing it loads neither JAX nor the JAX
package, no source file names them, and an entry point given no device
wants the card."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import cdmft_lanc_ed_torch as tpkg

PKG = pathlib.Path(tpkg.__file__).resolve().parent


def test_import_loads_no_jax():
    code = ("import sys, cdmft_lanc_ed_torch, cdmft_lanc_ed_torch.dmft_loop, "
            "cdmft_lanc_ed_torch.carry, cdmft_lanc_ed_torch.models.hubbard\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'cdmft_lanc_ed_tpu'))]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    p.relative_to(PKG).as_posix() for p in PKG.rglob("*")
    if p.suffix in (".py", ".cu") and "_build" not in p.parts))
def test_source_names_no_jax(path):
    text = (PKG / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax", text, re.M)
    assert "cdmft_lanc_ed_tpu" not in text


def _two_site_op(cfg, soc):
    """The (1, 1) sector of a bath-less two-site chain; ``soc`` adds an
    imaginary hopping, which makes the operator complex."""
    from cdmft_lanc_ed_torch.ops import sector_ham
    hloc = np.zeros((2, 2, 1, 1, 1, 1), np.complex128)
    hloc[0, 1, 0, 0, 0, 0] = -1.0 + 1j * soc
    hloc[1, 0, 0, 0, 0, 0] = -1.0 - 1j * soc
    return sector_ham.build_sector_operator(
        cfg, hloc, np.zeros((0,) + hloc.shape, np.complex128),
        np.zeros((2, 1, 1, 0)), 1, 1)


def test_no_device_means_the_card(monkeypatch, tmp_path):
    from cdmft_lanc_ed_torch import kit
    from cdmft_lanc_ed_torch.ops import split
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tpkg.EDConfig(nlat=1, nbath=0, work_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpkg.EDSolver(cfg)
    assert tpkg.EDSolver(cfg, device="cpu").device.type == "cpu"
    # the op builders: a real one and a pair one
    cfg2 = tpkg.EDConfig(nlat=2, nbath=0, work_dir=str(tmp_path))
    real_op, pair_op = _two_site_op(cfg2, 0.0), _two_site_op(cfg2, 0.3)
    assert split.op_is_real(real_op) and not split.op_is_real(pair_op)
    with pytest.raises(RuntimeError, match="CUDA"):
        kit.kit_for(real_op, torch.float64, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        kit.kit_for(pair_op, torch.float64, None)
    assert kit.kit_for(real_op, torch.float64, "cpu") \
        .dev.diag.device.type == "cpu"
    assert kit.kit_for(pair_op, torch.float64, "cpu") \
        .dev.hdw.device.type == "cpu"
