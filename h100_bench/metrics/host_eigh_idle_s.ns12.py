"""host_eigh_idle_s: device-idle seconds per solve under the program's
``lanczos.host_eigh`` spans (``dense_eigh`` of the small sectors and
``tridiag_eigh`` of each GF chain, both LAPACK on the host)."""
from program_spans import idle_per_solve


def read(run):
    return idle_per_solve(run, "lanczos.host_eigh")
