#!/usr/bin/env python3
"""The benchmark of cdmft_lanc_ed_torch on NVIDIA H100 cards.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json (at the root of the checkout) on this
machine's card and prints one JSON object as the last line of standard
output; see h100_bench/README.md.  Exits non-zero, printing no result,
without a CUDA card, without the program beside it, or when a module of
JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402


def main() -> int:
    from harness import cli
    return cli(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(main())
