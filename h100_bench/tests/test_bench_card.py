"""On the card: a traced run of the Ns=8 cell reads both kernels' launch
counts from the trace or the events, its roofline within 100%, and the
device's idle share.  Run on the card with
``python -m pytest h100_bench/tests -m cuda --noconftest -q``."""
import time

import pytest
import torch

import bench_helpers
import harness


@pytest.mark.cuda
def test_traced_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d, bench, cell = bench_helpers.tiny_bench(tmp_path)
    out = harness.run_cell(d, bench, cell, 2 ** 32 + 3, 2.0, True, "cuda",
                           time.perf_counter())
    assert out["correct"] is True
    dev = out["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    roof = out["metrics"]["real_kernel_roofline.ns12"]["value"]
    assert 0 < roof <= 105
    assert 0 <= out["metrics"]["device_idle.ns12"]["value"] < 100
    assert out["breakdown"]["device_ops"]
