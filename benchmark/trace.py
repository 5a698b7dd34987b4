"""Sums read from a torch.profiler run over some requests: device time by
kernel name, the device's busy time (the union of its operations'
intervals), and the idle gaps between them by the host operation that
was running at the gap's middle. Nothing is written to disk."""

from __future__ import annotations

import bisect
from collections import defaultdict

SPAN = "bench."  # the harness's own spans (torch.profiler.record_function)


def _events(prof):
    """(device ops as (name, start_ns, end_ns, card), host ops as (name,
    start_ns, end_ns))."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        if str(e.device_type()).endswith("CPU"):
            host.append((e.name(), start, start + e.duration_ns()))
        elif not (e.is_user_annotation() or e.name().startswith(SPAN)):
            # A span's mirror on the device's timeline is no device work.
            dev.append((e.name(), start, start + e.duration_ns(), e.device_index()))
    return dev, host


def _union(intervals):
    merged = []
    for s, e in sorted((r[1], r[2]) for r in intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "Memcpy ", "Memset "))


def summarize(prof, window_ns: tuple[int, int] | None = None, cards: int = 1,
              top: int = 10) -> dict:
    """Sums of one profiled span over `cards` cards. `window_ns` (host
    clock of the profiler, ns) bounds the busy and idle accounting;
    default: from the first to the last event. busy_s is the mean over
    the cards of each card's busy time; the idle gaps are the times when
    no card is busy."""
    dev, host = _events(prof)
    if window_ns is None:
        every = [r[1:3] for r in dev + host]
        window_ns = (min(s for s, _ in every), max(e for _, e in every)) if every else (0, 0)
    lo, hi = window_ns
    dev = [(n, max(s, lo), min(e, hi), c) for n, s, e, c in dev if e > lo and s < hi]
    by_name, by_card = defaultdict(float), defaultdict(float)
    kernels = 0
    for n, s, e, c in dev:
        by_name[n] += (e - s) * 1e-9
        by_card[(c, n)] += (e - s) * 1e-9
        kernels += is_kernel(n)
    per_card = defaultdict(list)
    for r in dev:
        per_card[r[3]].append(r)
    busy_s = sum(sum(e - s for s, e in _union(rs)) for rs in per_card.values()) * 1e-9 / cards
    busy = _union(dev)
    gaps, prev = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    # The host operation around each gap's middle that started last: on
    # one thread's nested spans, the innermost.
    host = sorted(host, key=lambda r: r[1])
    starts = [s for _, s, _ in host]
    gap_by = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid)
        name = "host (no operation)"
        for n, hs, he in reversed(host[max(0, i - 256):i]):
            if he >= mid:
                name = n
                break
        gap_by[name] += (e - s) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(window_s=(hi - lo) * 1e-9, busy_s=busy_s, kernels=kernels,
                device_s_by_name=dict(by_name), device_s_by_card=dict(by_card),
                device_ops=[[n, v] for n, v in ops[:top]],
                idle_gaps=[[n, v] for n, v in sorted(gap_by.items(), key=lambda kv: -kv[1])[:top]])


def device_s(summary: dict, pattern: str) -> float:
    """Device seconds of the operations whose name holds `pattern`,
    summed over the cards."""
    return sum(v for n, v in summary["device_s_by_name"].items() if pattern in n)


def busiest_card_s(summary: dict, pattern: str) -> float:
    """Device seconds of those operations on the card that ran them longest."""
    per = defaultdict(float)
    for (c, n), v in summary["device_s_by_card"].items():
        if pattern in n:
            per[c] += v
    return max(per.values(), default=0.0)
