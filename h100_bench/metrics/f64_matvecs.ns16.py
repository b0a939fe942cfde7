"""f64_matvecs: H·v in float64 per solve in the eigensolves (the
program's ``lanczos.matvecs.f64`` counter: Krylov steps, refine and
re-solves; a batched H·v counts once; GF chain steps are apart)."""
from program_spans import counter_per_solve


def read(run):
    return counter_per_solve(run, "lanczos.matvecs.f64")
