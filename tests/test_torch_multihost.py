"""Two gloo processes (raytracer_tpu_torch.parallel.multihost_demo, one
CPU shard each) ≡ one process: the gathered differentiable render and
the rebalanced wavefront bit for bit the single-device renders, on both
ranks; the train step across the processes equal to the in-process
two-shard step, and within loss rtol 1e-5 / params atol 1e-6 of the
unsharded step. Each worker has its own timeout, so a hang fails the
test instead of stalling the suite."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.diff import inverse
from raytracer_tpu_torch.models.wavefront import render_image_wavefront
from raytracer_tpu_torch.parallel import multihost_demo as demo
from raytracer_tpu_torch.parallel.sharding import make_mesh
from raytracer_tpu_torch.render import render_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120

torch.set_num_threads(2)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    addr = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, "-m", "raytracer_tpu_torch.parallel.multihost_demo",
                               addr, "2", str(rank), str(out), "--device", "cpu",
                               "--size", "small"],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in range(2)]
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
        logs.append(log.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def prob():
    return demo.problem("small", "cpu")


def test_ranks_agree_and_used_gloo(ranks):
    a, b = ranks
    assert str(a["backend"]) == "gloo" and str(b["backend"]) == "gloo"
    for k in a:
        if k not in ("seconds", "backend", "device"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_gathered_render_is_the_single_process_render(ranks, prob):
    cfg, cam = prob["render"]
    want = render_image(prob["scene"], cam, cfg, demo.SEED).numpy()
    np.testing.assert_array_equal(ranks[0]["img"], want)
    assert float(want.mean()) > 0.05


def test_rebalanced_across_processes_is_the_wavefront(ranks, prob):
    cfg, cam = prob["rebalance"]
    want = render_image_wavefront(prob["scene"], cam, cfg, demo.SEED).numpy()
    np.testing.assert_array_equal(ranks[0]["rebalanced"], want)
    it = ranks[0]["iters"]
    assert it.shape == (2,) and (it >= 1).all() and (it < cfg.spp * cfg.max_bounces + 8).all()


def test_train_step_across_processes(ranks, prob):
    in_process = demo.run(make_mesh(["cpu"] * 2), prob)
    got = ranks[0]
    assert got["loss"] == in_process["loss"]
    cfg, cam = prob["train"]
    params = prob["params"]
    p1, _, loss = inverse.make_train_step(prob["train_scene"], cam, cfg, prob["target"])(
        params, inverse.adam_init(params), demo.STEP_SEED)
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    for k in params:
        np.testing.assert_array_equal(got[f"param_{k}"], in_process[f"param_{k}"])
        np.testing.assert_allclose(got[f"param_{k}"], p1[k].numpy(), atol=1e-6)
