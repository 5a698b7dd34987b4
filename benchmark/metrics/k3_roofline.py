"""K3's share of its roofline: the frozen work of the traced requests'
paths (metrics/k3_roofline.json) at the H100 SXM's published peaks, over
K3's device time."""

from benchmark import manifest
from benchmark.metrics._common import roofline_pct


def read(run):
    return roofline_pct(run, "k3", manifest.metric_data("k3_roofline"))
