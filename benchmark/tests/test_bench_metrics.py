"""The metric readers and the trace sums, on canned profiler events."""

import pytest

from benchmark import manifest, trace
from benchmark.run import Run


class _Event:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def is_user_annotation(self):
        return self._n.startswith("bench.")

    def device_index(self):
        return 0


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})()})()


MS = 1_000_000  # ns


def canned():
    """Two requests of 100 ms: K3 runs 40 ms in each; the host builds the
    grid in the gaps; one copy."""
    ev = []
    for r in range(2):
        t = r * 100 * MS
        ev += [_Event("bench.request", "CPU", t, 100 * MS),
               _Event("bench.request", "CUDA", t + 52 * MS, 43 * MS),
               _Event("grid", "CPU", t + 1 * MS, 50 * MS),
               _Event("Memcpy HtoD", "CUDA", t + 52 * MS, 2 * MS),
               _Event("void fused_path_kernel<8, false>(x)", "CUDA", t + 55 * MS, 40 * MS)]
    return _Prof(ev)


def test_summarize_sums_busy_time_and_gaps():
    s = trace.summarize(canned(), (0, 200 * MS))
    assert s["window_s"] == pytest.approx(0.2)
    assert s["busy_s"] == pytest.approx(0.084)
    assert s["kernels"] == 2
    assert trace.device_s(s, "fused_path_kernel") == pytest.approx(0.08)
    assert s["device_ops"][0][0].startswith("void fused_path_kernel")
    gaps = dict(s["idle_gaps"])
    # 52 ms before the first copy, 57 from the first K3 to the second copy.
    assert gaps["grid"] == pytest.approx(0.109)
    assert sum(gaps.values()) == pytest.approx(0.2 - 0.084)


def _run(**kw):
    s = trace.summarize(canned(), (0, 200 * MS))
    base = dict(window_s=10.0, requests=20, work=20 * 1000, setup_s=12.5, trace=s,
                traced=[(0.1, 1000), (0.1, 1000)], untraced=[(0.125, 1000), (0.075, 1000)],
                kernels={"k3": "fused_path_kernel"},
                peak_bytes=3 * 2**30, scene_build_s=1.5, kernel_lib_load_s=0.25)
    base.update(kw)
    return Run(**base)


def read(name, run):
    return manifest.metric_reader(name).read(run)


def test_end_to_end_readers():
    run = _run()
    assert read("paths_per_s", run) == pytest.approx(2000.0)
    assert read("wavefront_paths_per_s", run) == pytest.approx(2000.0)
    assert read("train_step_s", run) == pytest.approx(0.5)
    assert read("setup_s", run) == 12.5


def test_per_layer_readers():
    run = _run()
    assert read("k3_ms_per_request", run) == pytest.approx(40.0)
    assert read("host_ms_per_request.fused", run) == pytest.approx(60.0)
    # Busy 42 ms a traced request against 100 ms a request outside the profiler.
    assert read("idle_share.fused", run) == pytest.approx(58.0)
    assert read("idle_share.train", _run(untraced=[(0.21, 1)])) == pytest.approx(80.0)
    assert read("kernels_per_frame.wavefront", run) == pytest.approx(1.0)
    assert read("peak_mem_gib.train", run) == pytest.approx(3.0)
    assert read("scene_build_s", run) == 1.5
    assert read("kernel_lib_load_s", run) == 0.25


def test_roofline_arithmetic():
    from benchmark.metrics import _common

    data = dict(ops_per_path=1e6, bytes_per_path=100.0, peak_flops=67e12,
                peak_bytes_per_s=3.35e12)
    run = _run()
    # 2,000 paths x 1e6 operations at 67 TFLOP/s over K3's 80 ms.
    want = 100.0 * 2000 * 1e6 / 67e12 / 0.08
    assert _common.roofline_pct(run, "k3", data) == pytest.approx(want)
    # The whole request's share: the paths outside the profiler over their wall time.
    assert _common.mfu_pct(run, data) == pytest.approx(100.0 * 2000 * 1e6 / 67e12 / 0.2)
    assert _common.mfu_pct(_run(untraced=[(0.5, 1000)]), data) == pytest.approx(
        100.0 * 1000 * 1e6 / 67e12 / 0.5)
    # Bytes bound where they dominate.
    heavy = dict(data, bytes_per_path=1e9)
    assert _common.roofline_pct(run, "k3", heavy) == pytest.approx(
        100.0 * 2000 * 1e9 / 3.35e12 / 0.08)


def test_readers_say_nothing_without_something_to_read():
    run = _run(trace=None)
    for name in ("k3_ms_per_request", "k3_roofline", "k4_roofline", "mfu.fused",
                 "idle_share.train", "kernels_per_step.train", "host_ms_per_request.fused"):
        assert read(name, run) is None, name
    # An entry without K4 gives no K4 roofline, never 0.
    assert read("k4_roofline", _run()) is None
    assert read("kernel_lib_load_s", _run(kernel_lib_load_s=0.0)) is None
    assert read("peak_mem_gib.train", _run(peak_bytes=0)) is None
    # A window whose every request was traced has no untraced wall time.
    for name in ("idle_share.fused", "mfu.fused", "host_ms_per_request.fused"):
        assert read(name, _run(untraced=[])) is None, name
