"""Milliseconds a wavefront frame spends in `rt.wavefront.grid`: the lane
grid and its copy to the card (program span)."""

from benchmark.metrics._spans import ms_per_root


def read(run):
    return ms_per_root(run, "rt.wavefront.grid")
