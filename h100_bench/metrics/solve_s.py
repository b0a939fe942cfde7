"""solve_s: the window's wall seconds over the solves it completed
(host clock; every solve ends in host reads of its results)."""


def read(run):
    return run.window_s / len(run.solves)
