"""gf_s: seconds per solve in the solver's "greens_functions" stage timer
(the 4-channel GF of a complex Hamiltonian)."""
from readers import stage_per_solve


def read(run):
    return stage_per_solve(run, "greens_functions")
