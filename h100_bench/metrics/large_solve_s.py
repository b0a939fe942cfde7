"""large_solve_s: solve_s of the Ns=16 cells, a metric of its own since
their runs spread less than the Ns=12 cells' (a bound is one number)."""


def read(run):
    return run.window_s / len(run.solves)
