"""raytracer_tpu_torch/utils/profiling.py ≡ the JAX package's Meter and
log_metrics (the same record, key for key), its trace writes a
TensorBoard trace, device_line gives a card's name and power limit or
raises, and the CLI's --profile traces the render, with the program's
spans, and logs the `render` record on every branch (the JAX CLI does
on --serve only). The recorder: an off span is one check of the
profiler's flag; spans nest, carry their request and sit on the
profiler's clock; counts land on the innermost span; a session sees
only its own spans; the benchmark's --trace 1 runs read them."""

import io
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import manifest
from benchmark import run as bench_run
from raytracer_tpu.utils import profiling as jprof
from raytracer_tpu_torch import cli
from raytracer_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _records(stream_text):
    return [json.loads(ln) for ln in stream_text.splitlines() if ln.startswith("{")]


def test_log_metrics_record_matches_jax():
    ours, theirs = io.StringIO(), io.StringIO()
    profiling.log_metrics("render", stream=ours, rays_per_sec=1.5e6, seconds=2.25)
    jprof.log_metrics("render", stream=theirs, rays_per_sec=1.5e6, seconds=2.25)
    a, b = json.loads(ours.getvalue()), json.loads(theirs.getvalue())
    assert list(a) == list(b) == ["tag", "time", "rays_per_sec", "seconds"]
    assert {k: v for k, v in a.items() if k != "time"} == {k: v for k, v in b.items()
                                                           if k != "time"}


def test_meter_matches_jax():
    ours, theirs = profiling.Meter(640, 360, 4), jprof.Meter(640, 360, 4)
    with ours:
        pass
    assert ours.elapsed >= 0.0
    ours.elapsed = theirs.elapsed = 0.125
    assert ours.camera_rays == theirs.camera_rays == 640 * 360 * 4
    assert ours.rays_per_sec == theirs.rays_per_sec
    ours.elapsed = theirs.elapsed = 0.0
    assert ours.rays_per_sec == theirs.rays_per_sec == 0.0


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with profiling.trace(str(tmp_path), "cpu"):
        torch.ones(64).cumsum(0)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


def test_device_line_names_the_cpu():
    assert profiling.device_line("cpu") == "cpu"


@pytest.mark.parametrize("rc, stdout, ok", [
    (0, "NVIDIA H100 80GB HBM3, 700.00 W\n", True),
    (0, "NVIDIA H100 80GB HBM3, [N/A]\n", False),
    (0, "", False),
    (9, "", False),
])
def test_device_line_needs_the_power_limit_of_a_card(monkeypatch, rc, stdout, ok):
    calls = []

    def smi(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, rc, stdout=stdout, stderr="")

    monkeypatch.setattr(subprocess, "run", smi)
    if ok:
        assert profiling.device_line("cuda:0") == stdout.strip()
    else:
        with pytest.raises(RuntimeError, match="no name and power limit"):
            profiling.device_line("cuda:0")
    assert calls == [["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]


def test_cli_profile_writes_a_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    out = tmp_path / "r.png"
    cli.main(["--scene", "cornell_spheres", "--width", "16", "--height", "8", "--spp", "1",
              "--max-bounces", "2", "--device", "cpu", "--out", str(out),
              "--profile", str(prof)])
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    recs = [r for r in _records(capsys.readouterr().err) if r.get("tag") == "render"]
    assert len(recs) == 1 and recs[0]["seconds"] > 0 and recs[0]["rays_per_sec"] > 0
    assert out.is_file()
    # The trace holds the program's spans of the render (the wavefront, the
    # CLI's default), as many as the recorder kept.
    with open(prof / files[0]) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("name", "").startswith("rt.")]
    kept = [r.name for r in profiling.recorded()]
    assert sorted(names) == sorted(kept)
    assert kept.count("rt.wavefront.render") == 1 and kept.count("rt.wavefront.grid") == 1
    assert {"rt.wavefront.stage", "rt.wavefront.read", "rt.wavefront.iteration"} <= set(kept)


# -- the recorder: spans and counters -----------------------------------------

def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class _Gate:
    """torch.autograd.profiler's flag, its reads counted."""

    def __init__(self, on: bool):
        self.on, self.reads = on, 0

    @property
    def _is_profiler_enabled(self):
        self.reads += 1
        return self.on


def test_off_span_is_one_check_and_records_nothing(monkeypatch):
    with _cpu_profile():
        with profiling.span("rt.test.before", root=True):
            pass
    before = profiling.recorded()

    def no_record_function(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    gate = _Gate(False)
    monkeypatch.setattr(profiling, "record_function", no_record_function)
    monkeypatch.setattr(profiling, "_autograd_profiler", gate)
    ctx = profiling.span("rt.test.off", root=True)
    assert gate.reads == 1
    with ctx as rec:
        with profiling.span("rt.test.off.child"):
            pass
    assert rec is None and gate.reads == 2
    assert ctx is profiling.span("rt.test.other")   # the one shared no-op context
    assert [r.id for r in profiling.recorded()] == [r.id for r in before]


def test_spans_nest_with_parents_requests_and_self_time():
    with _cpu_profile():
        for _ in range(2):
            with profiling.span("rt.test.root", root=True):
                time.sleep(0.002)
                for _ in range(2):
                    with profiling.span("rt.test.child"):
                        with profiling.span("rt.test.leaf"):
                            time.sleep(0.003)
    spans = profiling.recorded()
    by_id = {r.id: r for r in spans}
    roots = [r for r in spans if r.root]
    assert [r.name for r in roots] == ["rt.test.root"] * 2 and len(spans) == 10
    assert len({r.request for r in roots}) == 2
    for r in spans:
        if r.root:
            assert r.parent is None
            continue
        parent = by_id[r.parent]
        assert parent.name == {"rt.test.child": "rt.test.root",
                               "rt.test.leaf": "rt.test.child"}[r.name]
        assert r.request == parent.request
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    for root in roots:
        kids = profiling.children(root, spans)
        assert [k.name for k in kids] == ["rt.test.child"] * 2
        self_t = profiling.self_ns(root, spans)
        assert self_t == root.duration_ns - sum(k.duration_ns for k in kids)
        assert 2_000_000 <= self_t < root.duration_ns - 6_000_000
        for kid in kids:
            (leaf,) = profiling.children(kid, spans)
            assert profiling.self_ns(kid, spans) == kid.duration_ns - leaf.duration_ns
            assert profiling.self_ns(leaf, spans) == leaf.duration_ns


def test_spans_sit_on_the_profilers_clock():
    with _cpu_profile() as prof:
        with profiling.span("rt.test.clock", root=True):
            torch.ones(256).cumsum(0)
            with profiling.span("rt.test.clock.inner"):
                time.sleep(0.002)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = profiling.recorded()
    assert len(spans) == 2
    for r in spans:
        assert any(abs(s - r.start_ns) <= 1_000_000 and abs(e - r.end_ns) <= 1_000_000
                   for s, e in events.get(r.name, [])), (r, events.get(r.name))


def test_counts_land_on_the_innermost_span_and_totals_move():
    mine = profiling.group("test_recorder", ("a", "b"))
    loose0 = profiling.totals().get("test_recorder.loose", 0)
    mine.count("a")                               # no profiler: the total only
    assert mine == {"a": 1, "b": 0}
    with _cpu_profile():
        with profiling.span("rt.test.root", root=True):
            mine.count("a", 2)
            with profiling.span("rt.test.inner"):
                mine.count("b")
                profiling.count("test_recorder.loose", 5)
            worker = threading.Thread(target=mine.count, args=("b", 7))
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
        mine.count("a")                           # no open span: the total only
    root, inner = profiling.recorded()
    assert root.counts == {"test_recorder.a": 2, "test_recorder.b": 7}
    assert inner.counts == {"test_recorder.b": 1, "test_recorder.loose": 5}
    assert mine == {"a": 4, "b": 8}
    assert profiling.totals()["test_recorder.loose"] == loose0 + 5


def test_a_second_copy_of_a_module_keeps_its_own_counters(monkeypatch):
    """A module loaded again under another name (as a comparison against
    an older tree loads that tree's utils/ktf.py) counts into its own
    dicts, and the first copy's counters still move."""
    import importlib.util

    from raytracer_tpu_torch.utils import ktf

    spec = importlib.util.spec_from_file_location("second_ktf", ktf.__file__)
    second = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "second_ktf", second)
    spec.loader.exec_module(second)
    assert second.PLAIN_CALLS is not ktf.PLAIN_CALLS
    c = torch.arange(4, dtype=torch.int32)
    ours0, theirs0 = ktf.PLAIN_CALLS["threefry2x32"], second.PLAIN_CALLS["threefry2x32"]
    with _cpu_profile():
        with profiling.span("rt.test.root", root=True):
            ktf.threefry2x32(1, 2, c, c)
            second.threefry2x32(1, 2, c, c)
            second.threefry2x32(1, 2, c, c)
    assert ktf.PLAIN_CALLS["threefry2x32"] == ours0 + 1
    assert second.PLAIN_CALLS["threefry2x32"] == theirs0 + 2
    launches0 = dict(ktf.LAUNCHES)
    second.LAUNCHES.count("camera_draws")
    assert ktf.LAUNCHES == launches0 and second.LAUNCHES["camera_draws"] == 1
    (root,) = profiling.recorded()
    assert root.counts == {"plain.threefry2x32": 3}


def test_a_second_session_does_not_see_the_first():
    with _cpu_profile():
        with profiling.span("rt.test.first", root=True):
            profiling.count("host_reads")
    first = profiling.recorded()
    assert [r.name for r in first] == ["rt.test.first"]
    with _cpu_profile():
        pass
    assert profiling.recorded() == []
    with _cpu_profile():
        with profiling.span("rt.test.second", root=True):
            pass
    (second,) = profiling.recorded()
    assert second.name == "rt.test.second" and second.request != first[0].request


# -- the benchmark's readings of the spans ------------------------------------

TRAIN = manifest.config("inverse_materials_256")
TINY_IMAGE = dict(resolution=[16, 8], max_bounces=3)
TRACED = {
    "bunny2k_fused_hq": (TINY_IMAGE, ("grid_ms_per_request.fused",)),
    "bunny2k_wavefront": (TINY_IMAGE, (
        "grid_ms_per_frame.wavefront", "iterations_per_frame.wavefront",
        "dispatch_ms_per_iteration.wavefront", "read_wait_ms_per_frame.wavefront",
        "host_reads_per_frame.wavefront")),
    "inverse256_train": (dict(resolution=[16, 16], spp=2, max_bounces=4,
                              job=dict(TRAIN["job"], pairs=2, chunk=1)),
                         ("forward_ms_per_step.train", "backward_ms_per_step.train")),
}


@pytest.mark.parametrize("cell", list(TRACED))
def test_traced_run_reports_the_program_spans(monkeypatch, capsys, cell):
    """A --trace 1 run of each cell on the CPU reports its new metrics, read
    from one root span per traced request."""
    config_over, names = TRACED[cell]
    traffic = manifest.traffic(manifest.workload(manifest.benchmark(), cell)["traffic"])
    traffic_over = None
    if "check" in traffic and "pixels" in traffic["check"]:
        traffic_over = dict(spp_per_request=2, trace_requests=2,
                            check=dict(traffic["check"], requests=2, pixels=32))
    # This process holds the JAX package for the tests that compare with
    # it; the benchmark's own processes never do.
    monkeypatch.setattr(bench_run, "loaded_forbidden", lambda: [])
    rc = bench_run.main(["--workload", cell, "--seed", str(2**31 + 77), "--seconds", "0",
                         "--trace", "1"], device="cpu", config_over=config_over,
                        traffic_over=traffic_over)
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True
    for name in names:
        assert res["metrics"][name]["value"] > 0, name
    spans = profiling.recorded()
    roots = [r for r in spans if r.root]
    n_traced = (traffic_over or traffic)["trace_requests"]
    assert len(roots) == n_traced
    assert {r.name for r in roots} == {{"bunny2k_fused_hq": "rt.fused.render",
                                         "bunny2k_wavefront": "rt.wavefront.render",
                                         "inverse256_train": "rt.train.step"}[cell]}
    if cell != "bunny2k_wavefront":
        return
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.wavefront import cascade_caps
    from raytracer_tpu_torch.schedule import _tiled_pixel_grid

    w, h = config_over["resolution"]
    cfg = RenderConfig(width=w, height=h)
    caps = cascade_caps(_tiled_pixel_grid(cfg)[0].shape[0], cfg.drain_cascade)
    reads = 0
    for root in roots:
        mine = [r for r in spans if r.request == root.request]
        stages = [s for s in mine if s.name == "rt.wavefront.stage"]
        iters = [len(profiling.children(s, mine, "rt.wavefront.iteration")) for s in stages]
        n_reads = sum(r.counts.get("host_reads", 0) for r in mine)
        assert len(stages) == 1 + len(caps)
        assert n_reads == sum(iters) + 2 * len(caps) + 1
        reads += n_reads
    assert res["metrics"]["host_reads_per_frame.wavefront"]["value"] == reads / n_traced
