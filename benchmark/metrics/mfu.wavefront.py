"""The whole request's share of the card's published fp32 peak: the
frozen operations (metrics/k4_roofline.json) of the paths of the
window's requests outside the profiler over their wall time, by the host's
clock. It bounds K4's roofline share from below, whatever kernel or host
work fills the request."""

from benchmark import manifest
from benchmark.metrics._common import mfu_pct


def read(run):
    return mfu_pct(run, manifest.metric_data("k4_roofline"))
