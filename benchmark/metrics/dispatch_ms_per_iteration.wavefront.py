"""Mean milliseconds of a `rt.wavefront.iteration` span: the host
enqueueing one bounce of the buffer (program span)."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "rt.wavefront.iteration")
