"""Find a cell's parts by name: BENCHMARK.json at the checkout's root
names the cells and metrics; each configuration, traffic mix, entry and
metric is a file of its own under benchmark/, so a new one is a new file
and a new entry in BENCHMARK.json, with no edit to a file already here.

  configs/<config>.json    a configuration (scene, sizes, source, reduced)
  traffic/<traffic>.json   a traffic mix (entry, work per request, tracing)
  entries/<entry>.py       the calls into one entry point of the program
  metrics/<metric>.py      a reader of one metric (`read(run)`), with its
                           data in metrics/<metric>.json where it has any
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _named(kind: str, name: str, ext: str, here: str = HERE) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a name")
    path = os.path.join(here, kind, name + ext)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    return path


def config(name: str, here: str = HERE) -> dict:
    return load_json(_named("configs", name, ".json", here))


def traffic(name: str, here: str = HERE) -> dict:
    return load_json(_named("traffic", name, ".json", here))


def _module(kind: str, name: str, here: str = HERE):
    path = _named(kind, name, ".py", here)
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str, here: str = HERE):
    return _module("entries", name, here)


def metric_reader(name: str, here: str = HERE):
    return _module("metrics", name, here)


def metric_data(name: str, here: str = HERE):
    """metrics/<name>.json, or None where the metric has no data file."""
    path = os.path.join(here, "metrics", name + ".json")
    return load_json(path) if os.path.exists(path) else None


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(there are {[w['name'] for w in bench['workloads']]})")


def metrics_of(bench: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") that cell reports:
    those that list it under "workloads", and those with no such list."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def listing(here: str = HERE) -> dict:
    """Every configuration, traffic mix, entry and metric found on disk."""
    def names(kind, ext):
        d = os.path.join(here, kind)
        return sorted(f[:-len(ext)] for f in os.listdir(d)
                      if f.endswith(ext) and not f.startswith("_") and NAME.match(f[:-len(ext)]))
    return dict(configs=names("configs", ".json"), traffic=names("traffic", ".json"),
                entries=names("entries", ".py"), metrics=names("metrics", ".py"))
