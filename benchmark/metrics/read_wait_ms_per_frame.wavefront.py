"""Milliseconds a wavefront frame spends in `rt.wavefront.read`: the host
blocked on the card for the pending count (program span)."""

from benchmark.metrics._spans import ms_per_root


def read(run):
    return ms_per_root(run, "rt.wavefront.read")
