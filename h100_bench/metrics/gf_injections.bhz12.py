"""gf_injections: the GF's injection rows per solve (the program's
``gf.injections`` counter: diagonal, (a + b) and (a ± i b) rows of every
retained state, spin and create/destroy).  A program without the counter
reads nothing."""
from program_spans import counter_per_solve, window_solves


def read(run):
    solves = window_solves(run)
    if not solves or not any("gf.injections" in s["counters"]
                             for s in solves):
        return None
    return counter_per_solve(run, "gf.injections")
