"""Milliseconds of a fused request's wall time outside K3: the host's
lane grid, the copies, the launches and the gather (the mean wall time of
the window's requests outside the profiler minus K3's device time per
traced request, on the card that ran it longest)."""

from benchmark.metrics._common import kernel_s, untraced_request_s


def read(run):
    k3, wall = kernel_s(run, "k3", busiest=True), untraced_request_s(run)
    if k3 is None or wall is None:
        return None
    return 1e3 * (wall - k3 / len(run.traced))
