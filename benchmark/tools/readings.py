"""The readings a cell's limits are set from, in one process: for each
run seed, the requests the check compares, rendered by the program
(the window's own call at the cell's size) and compared with the
reference; then the control, the reference computed in bfloat16 in the
program's place, compared with the float32 reference on the same pixels.

    python3 -m benchmark.tools.readings <cell> <seed> [<seed> ...] [--control]
        [--fault <name>]

With --fault, the program runs with that fault of the entry's planted
under it (benchmark/faults.py).

Prints one JSON line per seed.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import torch

from benchmark import faults, manifest


def main(argv):
    control = "--control" in argv
    argv = [a for a in argv if a != "--control"]
    fault = None
    if "--fault" in argv:
        i = argv.index("--fault")
        fault = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    cell, seeds = argv[0], [int(s) for s in argv[1:]]
    bench = manifest.benchmark()
    w = manifest.workload(bench, cell)
    cfg, traffic = manifest.config(w["config"]), manifest.traffic(w["traffic"])
    devices = [torch.device("cuda", i) for i in range(w["chips"])]
    entry = manifest.entry(traffic["entry"])
    for s in seeds:
        t0 = time.perf_counter()
        runner = entry.Runner(cfg, traffic, s, devices, manifest.ROOT)
        with faults.plant(entry, fault) if fault else contextlib.nullcontext():
            runner.setup()
            runner.warmup()
            for i in range(traffic["check"].get("requests", 0)):
                runner.request(i)
        runner.free()
        t1 = time.perf_counter()
        row = dict(cell=cell, seed=s, fault=fault, program={c["name"]: c["value"] for c in runner.check()})
        t2 = time.perf_counter()
        if control:
            row["control_bf16"] = {c["name"]: c["value"] for c in runner.control()}
        row.update(render_s=t1 - t0, reference_s=t2 - t1, control_s=time.perf_counter() - t2)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
