"""Milliseconds a training step spends in `rt.train.backward`: its chunks'
torch.autograd.grad (program span)."""

from benchmark.metrics._spans import ms_per_root


def read(run):
    return ms_per_root(run, "rt.train.backward")
