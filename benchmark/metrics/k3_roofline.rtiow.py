"""K3's share of its roofline in the spheres-only cell: the frozen work of
the traced requests' paths (metrics/k3_roofline.rtiow.json: sphere-tree
steps, sphere tests, the sweep and K1's steps, from K3-profile's counts)
at the H100 SXM's published peaks, over K3's device time."""

from benchmark import manifest
from benchmark.metrics._common import roofline_pct


def read(run):
    return roofline_pct(run, "k3", manifest.metric_data("k3_roofline.rtiow"))
