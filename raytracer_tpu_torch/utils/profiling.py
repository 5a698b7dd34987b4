"""Tracing, counting, timing and metrics (port of raytracer_tpu/utils/profiling.py).

  * `span(name)` and `count(name, n)` are the program's own tracing. A
    span records its name, start and end (epoch ns, `time.time_ns()`,
    the clock of torch.profiler's events), its parent span and its
    request, and enters `torch.profiler.record_function(name)`, so the
    profiler's trace holds it under the same name. A root span (an
    entry point) opens a new request; its children inherit it.
    `recorded()` gives the spans of the latest recording session.
  * Recording is on exactly while a torch profiler records (the CLI's
    `--profile`, the benchmark's `--trace 1`, any
    `torch.profiler.profile`). Otherwise a span is one check of the
    profiler's flag and records nothing, and a count moves its total
    only.
  * A count moves an always-on total and, while recording, adds the
    same increment to the innermost open span of the thread (from
    another thread, such as autograd's, to the newest open request's
    root). `count(name, n)` counts by name (totals in `totals()`);
    `group(prefix, keys)` gives a module its counters as one dict of
    totals, such as the kernels' `LAUNCHES` and `PLAIN_CALLS`, which
    `LAUNCHES.count(key)` moves.
  * `trace(log_dir, device)` records a torch.profiler trace of the block (CPU
    activity, plus the card's kernels and copies when the device is a
    card) and writes it with `tensorboard_trace_handler(log_dir)`: a
    TensorBoard-viewable trace, as the JAX package's `jax.profiler` trace
    is;
  * `Meter` measures wall-clock and the derived camera rays/s the same
    way the benchmark harness does (camera rays = W·H·spp);
  * `log_metrics` is the single structured-logging choke point: one JSON
    record per call, {"tag", "time", then the metrics}.

Spans (`rt.` marks the program's own; "root" opens a request):

  rt.fused.render (root)      models/fused.render_image_fused: one image
    rt.fused.grid             the lane grid and its copy to the device
    rt.fused.pass             one path-loop call (K3, K5 or the plain loop), host side
    rt.fused.gather           the lanes back into image order
  rt.wavefront.render (root)  models/wavefront.render_image_wavefront: one image
    rt.wavefront.grid         the lane grid and its copy to the device
    rt.wavefront.stage        one drain stage, its compaction included
      rt.wavefront.read       the pending-count read: the host waits on the device
      rt.wavefront.iteration  one bounce of the buffer, enqueued by the host
  rt.train.step (root)        diff/inverse.make_train_step_accum: one Adam step
    rt.train.forward          a chunk's loss (diff/inverse.value_and_grad)
    rt.train.backward         its torch.autograd.grad
  rt.lbvh.traverse            ops/traverse.intersect_bvh: one lockstep traversal

Counters by name: `host_reads` (every device-to-host read of the
wavefront and the LBVH route), `wavefront.iterations` (the wavefront's
drain iterations) and `lbvh.steps` (the LBVH route's lockstep steps).
Groups: `launch.<kernel>` and `plain.<path>`, each module's `LAUNCHES`
and `PLAIN_CALLS` (the kernels' launches and their plain versions'
calls).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import sys
import threading
import time

from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function


class Span:
    """One recorded span: times in epoch ns; `parent` is the id of the
    enclosing span on the thread (None at the top); `request` the id of
    the request its root opened; `counts` the counts made while it was
    the innermost open span."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "request", "root", "counts")

    def __init__(self, id_, name, parent, request, root):
        self.id, self.name, self.parent, self.request, self.root = id_, name, parent, request, root
        self.start_ns = self.end_ns = None
        self.counts = {}

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, {self.start_ns}..{self.end_ns}, {self.counts})")


class _Recorder:
    """The spans of the latest recording session, the open spans of each
    thread and the open roots. A session starts when a profiler starts:
    the first span recorded chains the recorder onto
    torch.autograd.profiler's start hook, which sets the flag `span`
    reads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count()
        self.requests = itertools.count()
        self.records: list[Span] = []
        self.open_roots: list[Span] = []
        self.hooked = False

    def _new_session(self):
        with self.lock:
            self.records = []

    def _hook(self):
        with self.lock:
            if self.hooked:
                return
            self.hooked = True
            start = getattr(_autograd_profiler, "_run_on_profiler_start", None)
            if start is not None:
                def on_start():
                    start()
                    self._new_session()

                _autograd_profiler._run_on_profiler_start = on_start
        self._new_session()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def open(self, name: str, root: bool) -> Span:
        if not self.hooked:
            self._hook()
        st = self.stack()
        parent = st[-1] if st else None
        with self.lock:
            if root:
                request = next(self.requests)
            elif parent is not None:
                request = parent.request
            else:
                request = self.open_roots[-1].request if self.open_roots else None
            rec = Span(next(self.ids), name, parent.id if parent is not None else None,
                       request, root)
            self.records.append(rec)
            if root:
                self.open_roots.append(rec)
        st.append(rec)
        return rec

    def close(self, rec: Span):
        self.stack().pop()
        if rec.root:
            with self.lock:
                self.open_roots.remove(rec)

    def add(self, name: str, n: int):
        st = self.stack()
        with self.lock:
            rec = st[-1] if st else (self.open_roots[-1] if self.open_roots else None)
            if rec is not None:
                rec.counts[name] = rec.counts.get(name, 0) + n


_REC = _Recorder()


class _Open:
    """A span while a profiler records."""

    __slots__ = ("name", "root", "rec", "rf")

    def __init__(self, name: str, root: bool):
        self.name, self.root = name, root

    def __enter__(self) -> Span:
        self.rec = _REC.open(self.name, self.root)
        self.rec.start_ns = time.time_ns()
        self.rf = record_function(self.name)
        self.rf.__enter__()
        return self.rec

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.rec.end_ns = time.time_ns()
        _REC.close(self.rec)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, root: bool = False):
    """Context manager of one span (see the module's docstring). With no
    profiler recording: one check, and the shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, root)


def recorded() -> list[Span]:
    """The spans of the latest recording session, in the order they
    opened (those still open have no end)."""
    with _REC.lock:
        return list(_REC.records)


def children(rec: Span, spans: list[Span], name: str | None = None) -> list[Span]:
    """The spans of `spans` whose parent is `rec` (named `name`, if given)."""
    return [c for c in spans if c.parent == rec.id and (name is None or c.name == name)]


def self_ns(rec: Span, spans: list[Span]) -> int:
    """`rec`'s duration minus the part of it that its children cover."""
    kids = sorted((max(c.start_ns, rec.start_ns), min(c.end_ns, rec.end_ns))
                  for c in children(rec, spans) if c.end_ns is not None)
    covered, hi = 0, rec.start_ns
    for s, e in kids:
        s = max(s, hi)
        if e > s:
            covered += e - s
            hi = e
    return rec.duration_ns - covered


class Counters(dict):
    """The totals of a module's counters `<prefix>.<key>`, one entry per
    key (`group`). `c.count(key, n)` moves `c[key]` and, while a
    profiler records, the innermost open span's count of
    `<prefix>.<key>`. The totals belong to this dict alone: a second
    copy of the module (loaded under another name) keeps its own."""

    __slots__ = ("prefix",)

    def __init__(self, prefix: str, keys):
        super().__init__(dict.fromkeys(keys, 0))
        self.prefix = prefix

    def count(self, key: str, n: int = 1) -> None:
        self[key] += n
        if _autograd_profiler._is_profiler_enabled:
            _REC.add(f"{self.prefix}.{key}", n)


def group(prefix: str, keys) -> Counters:
    """A module's counters `prefix.<key>` as one dict of totals, such as
    the kernels' `LAUNCHES` and `PLAIN_CALLS`: code may read and reset it
    as it does any dict."""
    return Counters(prefix, keys)


_TOTALS: dict[str, int] = {}   # the totals of the counters counted by name


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`: its total always, and, while a
    profiler records, the innermost open span's count."""
    _TOTALS[name] = _TOTALS.get(name, 0) + n
    if _autograd_profiler._is_profiler_enabled:
        _REC.add(name, n)


def totals() -> dict[str, int]:
    """The totals of the counters counted by name (`count`) since the
    process started. A group's totals are its own dict."""
    return dict(_TOTALS)


@contextlib.contextmanager
def trace(log_dir: str, device):
    """Profiler trace of the block, written into `log_dir` (TensorBoard).
    `device`: the device the block runs on; the card's activity is
    recorded when it is a CUDA device."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class Meter:
    def __init__(self, width: int, height: int, spp: int):
        self.width, self.height, self.spp = width, height, spp
        self.t0 = None
        self.elapsed = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False

    @property
    def camera_rays(self) -> int:
        return self.width * self.height * self.spp

    @property
    def rays_per_sec(self) -> float:
        return self.camera_rays / self.elapsed if self.elapsed else 0.0


def log_metrics(tag: str, stream=None, **metrics) -> None:
    rec = {"tag": tag, "time": time.time(), **metrics}
    print(json.dumps(rec), file=stream or sys.stderr)


def device_line(device) -> str:
    """What ran the work: for a card, its name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them; "cpu" otherwise. Raises when nvidia-smi cannot give them for a
    card."""
    import subprocess

    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    if out.returncode != 0 or not line.rsplit(",", 1)[-1].strip().endswith(" W"):
        raise RuntimeError(f"nvidia-smi gave no name and power limit for card {index}: "
                           f"rc {out.returncode}, {out.stdout!r} {out.stderr!r}")
    return line
