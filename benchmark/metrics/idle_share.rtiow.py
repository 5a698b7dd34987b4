"""Percent of a request in which no operation ran on the card, in the
spheres-only cell: the busy time per traced request (the union of the
device operations' intervals) over the mean wall time of the window's
requests outside the profiler."""

from benchmark.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
