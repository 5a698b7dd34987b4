"""Device-to-host reads a wavefront frame makes: the counter
`host_reads` (pending counts and the cascade's nonzero counts; program
counter)."""

from benchmark.metrics._spans import counter_per_root


def read(run):
    return counter_per_root(run, "host_reads")
