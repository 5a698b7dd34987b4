"""Whole runs of each cell on the CPU at a tiny size, past the look for a
card, with the timed path sound and then broken underneath: the sound run
comes out correct, each fault the cell can have comes out not correct."""

import json

import pytest
import torch

from benchmark import faults, manifest, run

TINY_IMAGE = dict(resolution=[40, 24])
IMAGE_TRAFFIC = dict(spp_per_request=4)
TRAIN = manifest.config("inverse_materials_256")
TINY_TRAIN = dict(resolution=[16, 16], spp=2, max_bounces=4,
                  job=dict(TRAIN["job"], pairs=2, chunk=1))


def one_run(capsys, cell, config_over, traffic_over=None, seed=2**31 + 99):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0", "--trace", "0"],
                  device="cpu", config_over=config_over, traffic_over=traffic_over)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def image_traffic(cell):
    traffic = manifest.traffic(manifest.workload(manifest.benchmark(), cell)["traffic"])
    return dict(IMAGE_TRAFFIC, check=dict(traffic["check"], requests=2, pixels=96))


CELLS = {"bunny2k_fused_hq": (TINY_IMAGE, "image"), "bunny2k_wavefront": (TINY_IMAGE, "image"),
         "inverse256_train": (TINY_TRAIN, None)}


def cases():
    for cell in CELLS:
        w = manifest.workload(manifest.benchmark(), cell)
        for fault in (None,) + manifest.entry(manifest.traffic(w["traffic"])["entry"]).FAULTS:
            yield cell, fault


@pytest.mark.parametrize("cell,fault", list(cases()),
                         ids=[f"{c}-{f or 'sound'}" for c, f in cases()])
def test_cell_under_fault(capsys, cell, fault):
    over, kind = CELLS[cell]
    traffic = image_traffic(cell) if kind == "image" else None
    if fault is None:
        res = one_run(capsys, cell, over, traffic)
    else:
        w = manifest.workload(manifest.benchmark(), cell)
        entry = manifest.entry(manifest.traffic(w["traffic"])["entry"])
        with faults.plant(entry, fault):
            res = one_run(capsys, cell, over, traffic)
    assert res["correct"] is (fault is None), res["checks"]


def test_the_result_line_ends_with_the_checks(capsys):
    res = one_run(capsys, "bunny2k_fused_hq", TINY_IMAGE, image_traffic("bunny2k_fused_hq"))
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {"paths_per_s", "setup_s"}
    assert res["checks"]["mismatch_share"]["limit"] == manifest.traffic("fused_hq")[
        "check"]["limit"]


def test_no_result_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "bunny2k_fused_hq", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == ""
    assert "CUDA card" in captured.err


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, a run
    fails and prints no result."""
    import shutil
    import subprocess
    import sys

    shutil.copy(f"{manifest.ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "bunny2k_fused_hq", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""
