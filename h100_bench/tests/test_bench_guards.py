"""The run's guards: no JAX, a card or nothing, the program beside it."""
import os
import shutil
import subprocess
import sys

import bench_helpers
import harness


def test_forbidden_names_compare_whole_top_level_names():
    ok = ["cdmft_lanc_ed_torch", "cdmft_lanc_ed_torch.ops.fused", "numpy",
          "jaxtyping", "flaxen", "cdmft_lanc_ed_tpu_notes"]
    assert harness.forbidden_modules(ok) == []
    bad = ok + ["cdmft_lanc_ed_tpu.solver", "jaxlib.xla_client", "jax",
                "flax.linen"]
    assert harness.forbidden_modules(bad) == ["cdmft_lanc_ed_tpu", "flax",
                                              "jax", "jaxlib"]


def _run(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "plaquette_ns12.full_sweep", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_card_exits_nonzero_with_no_result():
    proc = _run(bench_helpers.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_alone_exits_nonzero_with_no_result(tmp_path):
    shutil.copy(bench_helpers.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench_helpers.BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, {})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
