"""The frozen roofline arithmetic reproduces the kernel table's bound
column (PERF.md, findings: the kernel table)."""
import numpy as np
import pytest

import bench_helpers  # noqa: F401  (paths)
import bounds
from reference.cluster_ed import bit_strings, hop_matrix
from reference.replica_hubbard import one_body


@pytest.mark.parametrize("b,ms", [(1, 0.0641), (4, 0.2565), (9, 0.5772)])
def test_fused_real_bound_at_the_1024_bucket(b, ms):
    s, by = bounds.fused_real_bound_s(b, 1024, 1024)
    assert round(s * 1e3, 4) == ms and by == "operations"


@pytest.mark.parametrize("b,ms", [(1, 0.1924), (4, 0.7695), (9, 1.7314)])
def test_fused_pair_bound_at_the_1024_bucket(b, ms):
    s, by = bounds.fused_pair_bound_s(b, 1024, 1024)
    assert round(s * 1e3, 4) == ms and by == "operations"


def test_blk_spmm_f32_bound_of_the_ns16_factor():
    # one side of the Ns=16 (8,8) sector: the spin factor over the 12,870
    # strings of 8 particles on 16 levels, padded to 12,928 rows
    h = np.array([[0, -1, -1, 0], [-1, 0, 0, -1], [-1, 0, 0, -1],
                  [0, -1, -1, 0]], float)
    rows, cols, _ = hop_matrix(bit_strings(16, 8),
                               one_body(h, [-1.0, 0.0, 1.0], [0.5] * 3, 0.0))
    nnz = len(rows)
    tiles = len(set(zip((rows // 128).tolist(), (cols // 128).tolist())))
    n = 12928
    compact, by = bounds.blk_bound_s("f32", nnz, n, n, n, 4 * nnz)
    dense, _ = bounds.blk_dense_bound_s("f32", tiles, nnz, n, n, n, 4)
    assert round(compact * 1e3, 4) == 0.3994 and by == "bytes"
    assert round(dense * 1e3, 4) == 0.4281


def test_peaks_follow_the_card_name():
    assert bounds.peaks_of("NVIDIA H100 80GB HBM3") == (67e12, 3.35e12)
    assert bounds.peaks_of("NVIDIA H100 PCIe") == (51e12, 2.0e12)
