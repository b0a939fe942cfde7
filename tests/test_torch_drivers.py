"""The 15 drivers of the port (``cdmft_lanc_ed_torch/drivers``) run to
their end on the CPU.

Each driver's ``main([..., "--cpu"])`` runs on a tiny input written to its
own directory (one bath at most, lmats 32, one loop iteration) and must
return finite numbers (the self-consistency error of a single iteration
is infinite by definition and is not checked).  The Kane-Mele hexagon and
the alternated BHZ cluster are cut to one sector by the reference's own
mechanism (ed_sectors with a sectors_list restart), since their smallest
bath gives Ns=12 and Ns=8.  The postprocessing drivers read the files of
no run and so periodize Sigma = 0.  No driver loads JAX.
"""
import dataclasses
import importlib
import numbers
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import threadpoolctl
import torch

import cdmft_lanc_ed_torch as tpkg

DRIVERS = pathlib.Path(tpkg.__file__).resolve().parent / "drivers"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One BLAS and one intra-op thread: the suite runs in several worker
    processes at once."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(nthreads)


INPUT = """NBATH={nbath}
ULOC=2.0,2.0
UST=0.5
BETA=20
LMATS=32
LREAL=16
LFIT=32
NLOOP=1
LANC_NGFITER=20
ED_VERBOSE=0
WORK_DIR={work_dir}
"""
SECTOR_CUT = "ED_SECTORS=T\nED_SECTORS_SHIFT=0\n"

# driver -> (flags, nbath, sweep cut to the (1,1) sector)
CASES = {
    "cdn_test": (["--nk", "4"], 1, False),
    "cdn_hm_1dchain": (["--nx", "2", "--nk", "8"], 1, False),
    "cdn_hm_2dsquare": (["--nx", "2", "--ny", "1", "--nk", "4"], 1, False),
    "cdn_ssh": (["--nk", "8"], 1, False),
    "cdn_kagome": (["--nk", "4", "--bands"], 1, False),
    "cdn_sg77": (["--nx", "1", "--nk", "3", "--bands"], 1, False),
    "cdn_bhz_1d": (["--nx", "1", "--nk", "8"], 1, False),
    "cdn_bhz_2d_alternated": (["--nk", "4"], 1, True),
    "cdn_bhz_2d": (["--nx", "1", "--ny", "1", "--nk", "4"], 1, False),
    "cdn_kanemele": (["--nk", "2", "--bands"], 1, True),
    "cdn_bhz_2d_edge": (["--nx", "1", "--ly", "2", "--nk", "4"], 1, False),
    "cdn_bhz_postprocessing": (["--nx", "1", "--ny", "1", "--nk-chern",
                                "4"], 1, False),
    "cdn_bhz_postprocessing_edge": (["--nx", "1", "--ly", "2", "--nkpath",
                                     "4"], 1, False),
    "cdn_ssh_postprocessing": (["--nk", "4", "--nkpath", "4"], 1, False),
    "retrieve_periodize": (["--nx", "2", "--ny", "1", "--nk", "4",
                            "--nkpath", "3"], 1, False),
}


def test_every_driver_has_a_case():
    assert sorted(p.stem for p in DRIVERS.glob("cdn_*.py")) \
        + ["retrieve_periodize"] == sorted(CASES)


def _numbers(obj, path="result"):
    """(path, value) of every number and numeric array in ``obj``: dicts,
    sequences and dataclasses are walked; the loop's error is left out."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k not in ("error", "errors"):
                yield from _numbers(v, f"{path}.{k}")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            if f.name not in ("error", "solver"):
                yield from _numbers(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _numbers(v, f"{path}[{i}]")
    elif isinstance(obj, np.ndarray) and obj.dtype.kind in "biufc":
        yield path, obj
    elif isinstance(obj, numbers.Number):
        yield path, np.asarray(obj)


@pytest.mark.parametrize("name", sorted(CASES))
def test_driver_runs_on_the_cpu(name, tmp_path):
    flags, nbath, cut = CASES[name]
    conf = tmp_path / "input.conf"
    conf.write_text(INPUT.format(nbath=nbath, work_dir=tmp_path)
                    + (SECTOR_CUT if cut else ""))
    if cut:
        (tmp_path / "sectors_list.restart").write_text(" 1 1\n")
    mod = importlib.import_module(f"cdmft_lanc_ed_torch.drivers.{name}")
    res = mod.main(["--input", str(conf), "--cpu"] + flags)
    found = list(_numbers(res))
    assert found, f"{name} returned no numbers"
    bad = [p for p, v in found if not np.isfinite(v).all()]
    assert not bad, f"{name}: non-finite {bad}"


def test_drivers_load_no_jax():
    mods = ", ".join(f"cdmft_lanc_ed_torch.drivers.{n}" for n in CASES)
    code = (f"import sys, {mods}\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'cdmft_lanc_ed_tpu'))]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(DRIVERS.parent.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
