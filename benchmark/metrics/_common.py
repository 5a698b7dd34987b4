"""Arithmetic the per-layer readers share: the wall time of the window's
requests outside the profiler, and a kernel's device time in the traced
requests, from benchmark/trace.summarize."""

from benchmark import trace


def traced_work(run) -> int:
    return sum(w for _, w in run.traced)


def untraced_request_s(run):
    """Mean wall time of the window's requests that ran outside the
    profiler, whose host cost would inflate it; None without any."""
    if not run.untraced:
        return None
    return sum(t for t, _ in run.untraced) / len(run.untraced)


def kernel_s(run, role: str, busiest: bool = False):
    """Device seconds of the entry's kernel `role` (its KERNELS table) in
    the traced requests, summed over the cards (or on the busiest card),
    or None when the entry runs no such kernel."""
    if run.trace is None or role not in run.kernels:
        return None
    pick = trace.busiest_card_s if busiest else trace.device_s
    s = pick(run.trace, run.kernels[role])
    return s if s > 0 else None


def roofline_pct(run, role: str, data: dict):
    """Percent of the published peak: the least time the card could take
    for the traced requests' paths (the frozen operations and bytes per
    path in `data`) over the kernel's device time."""
    s = kernel_s(run, role)
    if s is None or not data or data.get("ops_per_path") is None:
        return None
    return 100.0 * least_s(data, traced_work(run)) / s


def least_s(data: dict, paths: int) -> float:
    """The least time the card could take for `paths` paths: the larger
    of the frozen operations over the fp32 peak and the frozen bytes over
    the memory's peak."""
    return max(data["ops_per_path"] * paths / data["peak_flops"],
               data["bytes_per_path"] * paths / data["peak_bytes_per_s"])


def mfu_pct(run, data: dict):
    """Percent of the published fp32 peak: the frozen operations of the
    paths of the window's requests outside the profiler over those
    requests' wall time (host clock). The whole request's share, whatever
    kernel or host work fills it."""
    if run.trace is None or not run.untraced or not data or data.get("ops_per_path") is None:
        return None
    return 100.0 * data["ops_per_path"] * sum(w for _, w in run.untraced) \
        / data["peak_flops"] / sum(t for t, _ in run.untraced)


def idle_pct(run):
    """Percent of a request in which no operation runs on the card: the
    card's busy time per traced request (the union of its operations'
    intervals) over the mean wall time of the requests outside the
    profiler."""
    wall = untraced_request_s(run)
    if run.trace is None or not run.traced or wall is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / len(run.traced) / wall)
