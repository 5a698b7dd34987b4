"""Drain iterations a wavefront frame runs: its `rt.wavefront.iteration`
spans, one bounce of the buffer each (program span)."""

from benchmark.metrics._spans import count_per_root


def read(run):
    return count_per_root(run, "rt.wavefront.iteration")
