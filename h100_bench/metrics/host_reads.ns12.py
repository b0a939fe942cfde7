"""host_reads: the program's explicit device-to-host reads per solve
(its ``host_reads`` counter; on the card each one waits for the
device)."""
from program_spans import counter_per_solve


def read(run):
    return counter_per_solve(run, "host_reads")
