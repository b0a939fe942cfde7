"""The port stands alone: importing it loads neither JAX nor the JAX
package, no source file names them, and an entry point given no device
wants the card."""
import pathlib
import re
import subprocess
import sys

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


def test_no_device_means_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tpkg.EDConfig(nlat=1, nbath=0, work_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpkg.EDSolver(cfg)
    assert tpkg.EDSolver(cfg, device="cpu").device.type == "cpu"
