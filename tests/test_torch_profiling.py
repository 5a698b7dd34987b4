"""raytracer_tpu_torch/utils/profiling.py ≡ the JAX package's Meter and
log_metrics (the same record, key for key), its trace writes a
TensorBoard trace, device_line gives a card's name and power limit or
raises, and the CLI's --profile traces the render and logs the
`render` record on every branch (the JAX CLI does on --serve only)."""

import io
import json
import os
import subprocess

import pytest
import torch

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
