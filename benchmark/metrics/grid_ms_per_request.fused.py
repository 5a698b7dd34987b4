"""Milliseconds a fused request spends in `rt.fused.grid`: the lane grid
and its copy to the card (program span)."""

from benchmark.metrics._spans import ms_per_root


def read(run):
    return ms_per_root(run, "rt.fused.grid")
