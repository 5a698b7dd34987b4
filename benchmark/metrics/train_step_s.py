"""Seconds per Adam step: the window over the steps it completed."""


def read(run):
    return run.window_s / run.requests
