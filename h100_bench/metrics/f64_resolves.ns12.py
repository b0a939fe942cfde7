"""f64_resolves: sectors re-solved in f64 after the mixed refine missed
its tolerance (the program's lanczos.f64_fallbacks over the window), per
solve."""


def read(run):
    return run.counters["f64_fallbacks"] / len(run.solves)
