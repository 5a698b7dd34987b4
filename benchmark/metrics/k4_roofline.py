"""K4's share of its roofline in the wavefront: the frozen work of the
traced requests' paths (metrics/k4_roofline.json) at the H100 SXM's
published peaks, over K4's device time."""

from benchmark import manifest
from benchmark.metrics._common import roofline_pct


def read(run):
    return roofline_pct(run, "k4", manifest.metric_data("k4_roofline"))
