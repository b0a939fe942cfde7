"""f64_resolve_s: host seconds per solve in the program's
``lanczos.f64_resolve`` spans: the f64 re-solves of sectors whose mixed
refine missed its tolerance."""
from program_spans import span_s_per_solve


def read(run):
    return span_s_per_solve(run, "lanczos.f64_resolve")
