"""restart_idle_s: device-idle seconds per solve under the program's
``lanczos.restart`` spans (the host part of each thick restart: the two
reads of the projections, the Ritz problem on the host, the upload of
the kept Ritz rotation)."""
from program_spans import idle_per_solve


def read(run):
    return idle_per_solve(run, "lanczos.restart")
