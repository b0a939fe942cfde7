"""gf_s: seconds per solve in the solver's "greens_functions" stage
timer (GF chains, G and Sigma), mean over the window's solves."""
from readers import stage_per_solve


def read(run):
    return stage_per_solve(run, "greens_functions")
