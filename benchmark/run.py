"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Set-up (imports, the kernel library, the scene and its tree, the
entry's warm-up) is timed from the start of this module; then the window
runs whole requests from one client until the first that finishes after
`--seconds`. With `--trace 1` a fixed number of the window's requests
(the traffic's "trace_requests", after "trace_skip") run under
torch.profiler, and the per-layer metrics are printed in place of the
end-to-end ones. After the window, the program's state is freed and the
plain reference (benchmark/reference) checks the answers.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with --trace 1), then checks.
The numbers compared, each beside its limit, are also the last lines of
standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import manifest  # noqa: E402

# Compile caches at fixed paths inside the checkout, so that only a cell's
# first run in a checkout builds anything.
CACHE = os.path.join(manifest.HERE, ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")


class Run:
    """What the metric readers read: the window, the set-up and, with
    --trace 1, the profiler's sums (benchmark/trace.summarize)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def loaded_forbidden() -> list[str]:
    """Modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_line(index: int) -> str:
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or f"nvidia-smi: rc {out.returncode} {out.stderr.strip()}"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: str | None = None, config_over: dict | None = None,
         traffic_over: dict | None = None) -> int:
    """One run. `device` other than None skips the look for cards and runs
    there (the CPU tests run the program's plain versions so); the
    `*_over` dicts update the cell's configuration and traffic."""
    args = parse(argv)
    bench = manifest.benchmark()
    cell = manifest.workload(bench, args.workload)
    cfg = {**manifest.config(cell["config"]), **(config_over or {})}
    traffic = {**manifest.traffic(cell["traffic"]), **(traffic_over or {})}

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
                  f"this machine has {n}", file=sys.stderr)
            return 2
        devices = [torch.device("cuda", i) for i in range(cell["chips"])]
        torch.cuda.set_device(devices[0])
    else:
        devices = [torch.device(device)]
    cuda = devices[0].type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    mod = manifest.entry(traffic["entry"])
    runner = mod.Runner(cfg, traffic, args.seed, devices, manifest.ROOT)
    parts = runner.setup()
    runner.warmup()
    setup_s = time.perf_counter() - T_START

    if cuda:
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    prof, traced, untraced, summary = None, [], [], None
    skip, n_trace = traffic.get("trace_skip", 1), traffic.get("trace_requests", 1)
    work, i = 0, 0
    t0 = time.perf_counter()
    while True:
        if args.trace and i == skip:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
        r0 = time.perf_counter()
        if prof is not None and skip <= i < skip + n_trace:
            with record_function("bench.request"):
                w = runner.request(i)
            traced.append((time.perf_counter() - r0, w))
        else:
            w = runner.request(i)
            untraced.append((time.perf_counter() - r0, w))
        work += w
        i += 1
        if prof is not None and i == skip + n_trace:
            prof.__exit__(None, None, None)
            from benchmark import trace

            spans = [e for e in prof.profiler.kineto_results.events()
                     if e.name() == "bench.request"]
            lo = min(e.start_ns() for e in spans)
            hi = max(e.start_ns() + e.duration_ns() for e in spans)
            summary = trace.summarize(prof, (lo, hi), cards=len(devices))
            prof = None
        if time.perf_counter() - t0 >= args.seconds and (not args.trace or summary is not None):
            break
    window_s = time.perf_counter() - t0
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else 0

    runner.free()
    checks = runner.check()
    correct = all(c["value"] <= c["limit"] for c in checks)

    run = Run(cell=cell, config=cfg, traffic=traffic, setup_s=setup_s, window_s=window_s,
              requests=i, work=work, peak_bytes=peak, trace=summary, traced=traced,
              untraced=untraced,
              kernels=getattr(mod, "KERNELS", {}), **parts)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_of(bench, cell["name"], kind):
        value = manifest.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = loaded_forbidden()
    if found:
        print(f"benchmark: the process loaded {found}: the port must not load JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    dev = {"platform": "gpu" if cuda else devices[0].type,
           "kind": torch.cuda.get_device_name(devices[0]) if cuda else devices[0].type,
           "count": len(devices), "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    if cuda:
        for d in devices:
            print(f"card {d.index}: {card_line(d.index)}", file=sys.stderr)
    out = {"correct": correct, "attempted": i, "failed": 0, "metrics": metrics, "device": dev}
    if summary is not None:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
