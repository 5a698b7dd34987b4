"""Milliseconds a training step spends in `rt.train.forward`: its chunks'
loss renders (program span)."""

from benchmark.metrics._spans import ms_per_root


def read(run):
    return ms_per_root(run, "rt.train.forward")
