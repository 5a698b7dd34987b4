"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup by name: every part is found, and a part added as files alone is
listed with no edit."""

import json
import os
import shutil

import pytest

from benchmark import manifest

BENCH = manifest.benchmark()
E2E = {m["name"] for m in BENCH["end_to_end"]}


def all_names():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in BENCH[kind]:
            yield x["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(all_names())))
def test_names_use_the_allowed_characters(name):
    assert manifest.NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert manifest.UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert metric["moves"] in E2E
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert "\n" not in metric["layer"] and 0 < len(metric["layer"]) <= 200
        # Every cell that reports it also reports the metric it moves.
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert cell in moved.get("workloads", [cell])
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    # A full check of 24 cells fits in its 43,200 seconds.
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_parts(cell):
    cfg = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    assert manifest.entry(traffic["entry"]).Runner
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert conf["file"] == f"benchmark/configs/{cell['config']}.json"
    assert sorted(conf["reduced"]) == sorted(cfg["reduced"])
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    e2e = [m["name"] for m in manifest.metrics_of(BENCH, cell["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = manifest.metrics_of(BENCH, cell["name"], "per_layer")
    assert per
    for m in manifest.metrics_of(BENCH, cell["name"], "end_to_end") + per:
        assert callable(manifest.metric_reader(m["name"]).read)


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_parts_added_as_files_are_found_without_edits(tmp_path):
    here = tmp_path / "benchmark"
    shutil.copytree(manifest.HERE, here, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = manifest.listing(str(here))
    (here / "configs" / "extra_scene.json").write_text(json.dumps({"name": "extra_scene"}))
    (here / "traffic" / "extra_mix.json").write_text(json.dumps({"entry": "fused"}))
    (here / "metrics" / "extra_metric.py").write_text("def read(run):\n    return 7.0\n")
    (here / "metrics" / "extra_metric.json").write_text(json.dumps({"k": 1}))
    after = manifest.listing(str(here))
    assert after["configs"] == sorted(before["configs"] + ["extra_scene"])
    assert after["traffic"] == sorted(before["traffic"] + ["extra_mix"])
    assert after["metrics"] == sorted(before["metrics"] + ["extra_metric"])
    assert manifest.config("extra_scene", str(here)) == {"name": "extra_scene"}
    assert manifest.traffic("extra_mix", str(here))["entry"] == "fused"
    assert manifest.metric_reader("extra_metric", str(here)).read(None) == 7.0
    assert manifest.metric_data("extra_metric", str(here)) == {"k": 1}
    # Existing files are untouched by the additions.
    for kind in ("configs", "traffic", "entries", "metrics"):
        for f in os.listdir(os.path.join(manifest.HERE, kind)):
            src = os.path.join(manifest.HERE, kind, f)
            if os.path.isfile(src):
                assert (here / kind / f).read_bytes() == open(src, "rb").read()


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        manifest.config("no_such_config")
    with pytest.raises(ValueError):
        manifest.traffic("../BENCHMARK")
    with pytest.raises(KeyError):
        manifest.workload(BENCH, "no_such_cell")

