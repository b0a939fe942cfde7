"""diag_s: seconds per solve in the solver's "diagonalization" stage
timer (the sector sweep), mean over the window's solves."""
from readers import stage_per_solve


def read(run):
    return stage_per_solve(run, "diagonalization")
