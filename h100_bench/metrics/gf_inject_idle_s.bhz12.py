"""gf_inject_idle_s: device-idle seconds per solve under the program's
``gf.inject`` spans: the host build of each (state, spin, create)'s
injection rows (the excitations, the recipe, the rows, and for a dense
target sector the read to the host before the chains' upload).  A
program without the span reads nothing."""
from program_spans import idle_per_solve


def read(run):
    if not any("gf.inject" in s["stages"] for s in run.solves):
        return None
    return idle_per_solve(run, "gf.inject")
