"""expand_idle_s: device-idle seconds per solve under the program's
``lanczos.expand`` spans: the host gap of the Lanczos steps, whose small
launches the host issues one step at a time."""
from program_spans import idle_per_solve


def read(run):
    return idle_per_solve(run, "lanczos.expand")
