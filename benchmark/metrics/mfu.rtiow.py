"""The whole request's share of the card's published fp32 peak in the
spheres-only cell: the frozen operations (metrics/k3_roofline.rtiow.json)
of the paths of the window's requests outside the profiler over their
wall time, by the host's clock (mfu.fused's form)."""

from benchmark import manifest
from benchmark.metrics._common import mfu_pct


def read(run):
    return mfu_pct(run, manifest.metric_data("k3_roofline.rtiow"))
