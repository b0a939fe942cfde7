"""factor_build_s: host seconds per solve in the program's
``large.build`` spans: every build of a large sector's block-sparse
operator (block factors on the host, tiles and indices on the card), in
any precision."""
from program_spans import span_s_per_solve


def read(run):
    return span_s_per_solve(run, "large.build")
