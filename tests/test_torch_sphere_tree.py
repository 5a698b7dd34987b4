"""The sphere tree (scene/builder.build_sphere_tree) and the scenes of
spheres alone, on the CPU: the tree's plain search gives the sweep's
sphere bit for bit, a scene needs no OBJ file, the fused path takes any
number of spheres and materials (above 16 spheres through the tree), and
the "Ray Tracing in One Weekend" configuration, its generator, its
reference and its cell hold together."""

import json

import numpy as np
import pytest
import torch

from benchmark import check, manifest, program, run
from benchmark.tools import rtiow_scene
from raytracer_tpu_torch.ops import cuda_megakernel, cuda_traverse
from raytracer_tpu_torch.ops.sphere import BIG, closest_sphere_tree, intersect_spheres
from raytracer_tpu_torch.scene import builder
from raytracer_tpu_torch.scene.obj_io import load_scene_objs
from raytracer_tpu_torch.scene.types import Spheres
from raytracer_tpu_torch.utils import profiling

CELL = "rtiow1200_fused_500spp"
SEED = 2**31 + 4242


def random_spheres(seed, n):
    """n spheres over a 24 x 24 floor (radius 0.05-0.4), the radius-1000
    ground first, and exact duplicates (equal roots: ties)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-12.0, 12.0, (n, 3)).astype(np.float32)
    c[:, 1] = rng.uniform(0.0, 2.0, n)
    r = rng.uniform(0.05, 0.4, n).astype(np.float32)
    c[0], r[0] = (0.0, -1000.0, 0.0), 1000.0
    for a, b in ((3, 4), (10, 11), (n - 2, n - 1)):
        c[b], r[b] = c[a], r[a]
    return Spheres.from_lists(c, r, np.arange(n) % 7)


def rtiow_with_tree():
    """The committed RTIOW configuration's scene as the benchmark builds it
    (benchmark/program.scene), with its sphere tree."""
    sc, _ = program.scene(manifest.config("rtiow_final_1200"), manifest.ROOT, "cpu")
    return sc.replace(sphere_tree=builder.build_sphere_tree(sc.spheres))


def rays(seed, spheres, n):
    """Rays from the floor's space in every direction, some from inside a
    sphere, some aimed at a duplicated sphere's centre, some grazing."""
    rng = np.random.default_rng(seed + 1)
    o = rng.uniform(-14.0, 14.0, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1])
    d = rng.normal(size=(n, 3)).astype(np.float32)
    c, r = spheres.center.numpy(), spheres.radius.numpy()
    o[: n // 8] = c[5]                                        # inside sphere 5
    d[n // 8: n // 4] = c[3] - o[n // 8: n // 4]              # at a tied pair
    k = rng.integers(1, c.shape[0], n // 8)                   # grazing
    side = np.cross(d[n // 4: n // 4 + n // 8], (0.0, 1.0, 0.0))
    side /= np.maximum(np.linalg.norm(side, axis=1, keepdims=True), 1e-6)
    o[n // 4: n // 4 + n // 8] = c[k] + side * r[k, None] - 20.0 * d[n // 4: n // 4 + n // 8]
    far = slice(n // 2, n // 2 + n // 8)                      # from far on the ground
    k = rng.integers(1, c.shape[0], n // 8)
    o[far] = rng.uniform(-800.0, 800.0, (n // 8, 3))
    o[far, 1] = 0.0
    d[far] = c[k] + rng.normal(scale=0.3, size=(n // 8, 3)) - o[far]
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_search_equals_the_sweep(seed):
    sp = random_spheres(seed, 300 + 50 * seed)
    tree = builder.build_sphere_tree(sp)
    assert tree.sweep.tolist() == [0]               # the ground alone
    o, d = rays(seed, sp, 4096)
    t_sweep, id_sweep = intersect_spheres(o, d, sp.center, sp.radius, 1e-3, BIG)
    t_tree, id_tree, steps, tests = closest_sphere_tree(o, d, sp, tree, 1e-3, count=True)
    assert torch.equal(t_tree, t_sweep) and torch.equal(id_tree, id_sweep)
    hit = t_sweep < BIG
    assert 0.3 < hit.float().mean().item() < 0.95
    # Sphere 4 is sphere 3 again: every tie goes to 3, in both searches.
    assert (id_sweep == 3).sum() > 0 and (id_sweep == 4).sum() == 0
    near = o.norm(dim=1) < 20.0
    assert (steps >= 1).all() and (~near).float().mean() > 0.1
    # Boxes grow with the origin's distance: far rays test more spheres.
    assert tests[near].float().mean() < 0.1 * sp.count < tests[~near].float().mean()


def test_the_lbvh_tree_equals_the_sweep_where_the_native_builder_is_unavailable(monkeypatch):
    def unavailable(mesh):
        raise builder.native.NativeUnavailable("no g++ here")

    monkeypatch.setattr(builder.native, "build_bvh4_native", unavailable)
    sp = random_spheres(4, 250)
    with pytest.warns(UserWarning, match="native builder is unavailable"):
        tree = builder.build_sphere_tree(sp)
    ids = tree.ids[tree.ids >= 0]
    assert sorted(ids.tolist()) == list(range(1, 250)) and tree.sweep.tolist() == [0]
    o, d = rays(4, sp, 2048)
    t_sweep, id_sweep = intersect_spheres(o, d, sp.center, sp.radius, 1e-3, BIG)
    t_tree, id_tree = closest_sphere_tree(o, d, sp, tree, 1e-3)
    assert torch.equal(t_tree, t_sweep) and torch.equal(id_tree, id_sweep)


def test_tree_boxes_hold_their_spheres():
    sp = random_spheres(7, 200)
    sweep, rest = builder.partition_sweep_spheres(sp.radius.numpy())
    assert sweep.tolist() == [0] and rest.tolist() == list(range(1, 200))
    boxes = builder.sphere_boxes(sp.center.numpy()[rest], sp.radius.numpy()[rest])
    c, r = sp.center.numpy()[rest], sp.radius.numpy()[rest, None]
    assert boxes.dtype == np.float32
    assert (boxes[:, 0:3] <= c - r).all() and (boxes[:, 3:6] >= c + r).all()
    cx, cy, cz, h, ga, gb, gc = builder.sphere_growth(c, r[:, 0])
    assert np.linalg.norm(c - (cx, cy, cz), axis=1).max() == pytest.approx(h)
    assert ga > 0 and gb > 0 and gc > 0
    # Forty spheres of one radius: no sphere dwarfs the median, none is swept.
    assert builder.partition_sweep_spheres(np.full(40, 0.2))[0].size == 0


def test_a_scene_with_no_obj_file():
    mesh, mats = load_scene_objs([])
    assert mats.count == 0 and mesh.num_tris == 1
    bvh = builder.build_scene_bvh4(mesh)
    o = torch.tensor([[0.0, 0.0, -1.0], [0.1, 0.2, 0.3]])
    d = torch.tensor([[0.0, 0.0, 1.0], [-0.1, -0.2, -0.3]])
    t, prim, _, _ = cuda_traverse._traverse_plain(o, d, bvh, torch.full((2,), 1e30), 1e-3)
    assert (prim == -1).all() and (t == 1e30).all()


def test_the_generator_writes_the_committed_configuration():
    with open(rtiow_scene.PATH) as f:
        assert f.read() == rtiow_scene.dumps(rtiow_scene.config())
    cfg = manifest.config("rtiow_final_1200")
    scene = cfg["scene"]
    assert len(scene["spheres"]) == len(scene["materials"]) == 487
    assert [s["material"] for s in scene["spheres"]] == list(range(487))
    assert scene["spheres"][0]["radius"] == 1000.0 and cfg["reduced"] == []
    assert cfg["resolution"] == [1200, 675] and cfg["spp"] == 500 and cfg["max_bounces"] == 50


def test_the_camera_looks_from_13_2_3_at_the_origin():
    from raytracer_tpu_torch.camera import camera_basis

    cfg = manifest.config("rtiow_final_1200")
    rcfg = program.render_config(cfg)
    basis = camera_basis(program.camera(cfg, rcfg))
    w, h = rcfg.width, rcfg.height
    centre = (basis["lower_left"] + 0.5 * basis["horizontal"] + 0.5 * basis["vertical"]
              - torch.tensor(cfg["camera"]["position"]))
    view = centre / centre.norm()
    want = -torch.tensor([13.0, 2.0, 3.0]) / np.sqrt(182.0)
    assert torch.allclose(view, want, atol=1e-5)
    assert float(centre.norm()) == pytest.approx(10.0, rel=1e-5)    # the focus distance
    vfov = 2 * np.degrees(np.arctan(0.5 * float(basis["vertical"].norm()) / 10.0))
    assert vfov == pytest.approx(20.0, rel=1e-5) and w / h == pytest.approx(16 / 9, rel=1e-3)


def test_the_rtiow_scene_and_its_tree():
    sc = rtiow_with_tree()
    assert sc.spheres.count == 487 and sc.materials.count == 487
    assert sc.sphere_tree.sweep.tolist() == [0]
    ids = sc.sphere_tree.ids
    assert sorted(ids[ids >= 0].tolist()) == list(range(1, 487))
    assert cuda_megakernel.fused_megakernel_available(sc)
    why = cuda_megakernel.fused_unavailable(sc.replace(sphere_tree=None))
    assert "487 spheres" in why and "sphere tree" in why


def test_the_tree_build_records_its_span_and_node_count():
    sp = random_spheres(3, 120)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tree = builder.build_sphere_tree(sp)
    spans = [r for r in profiling.recorded() if r.name == "rt.scene.sphere_tree"]
    assert len(spans) == 1 and spans[0].counts.get("sphere_tree.nodes") == tree.nodes > 1


def test_launch_keys_of_the_tree_instantiations():
    for key in ("render_fused_tree", "render_fused_g2_tree", "render_fused_profile_tree"):
        assert key in cuda_megakernel.LAUNCHES


def _tiny_cfg(res=(48, 27)):
    cfg = manifest.config("rtiow_final_1200")
    cfg["resolution"] = list(res)
    return cfg


def test_plain_profile_counts_the_tree_walk():
    """The plain K3-profile of a tree scene returns each lane's sphere-tree
    steps and tests beside its K1 steps and path iterations, and its
    radiance is the plain K3's."""
    from raytracer_tpu_torch.models.fused import _fused_pixel_grid

    cfg = _tiny_cfg((32, 32))
    cfg.update(max_bounces=6, min_bounces=6)
    rcfg = program.render_config(cfg)
    cam = program.camera(cfg, rcfg)
    sc = rtiow_with_tree()
    px, py, _ = _fused_pixel_grid(rcfg)
    px, py = torch.as_tensor(px), torch.as_tensor(py)
    out = cuda_megakernel.render_tiles_fused_plain(sc, cam, rcfg, SEED, px, py, spp=1,
                                                   profile=True, lane_counts=True)
    assert len(out) == 7
    rgb, _, _, k1, iters, steps, tests = out
    assert torch.equal(rgb, cuda_megakernel.render_tiles_fused_plain(sc, cam, rcfg, SEED, px, py,
                                                                     spp=1))
    assert (steps >= iters).all() and (tests > 0).any() and (k1 >= iters).all()


def test_plain_fused_render_agrees_with_the_reference():
    """The plain fused render of the whole scene at 48 x 27, 4 spp, 50
    bounces against benchmark/reference/spheres.py, within the cell's
    check limits; the bfloat16 reference fails them."""
    from benchmark.reference import spheres
    from benchmark.reference.scene import camera_frame
    from raytracer_tpu_torch.models import fused

    cfg = _tiny_cfg()
    rcfg = program.render_config(cfg)
    sc, _ = program.scene(cfg, manifest.ROOT, "cpu")
    sc = sc.replace(sphere_tree=builder.build_sphere_tree(sc.spheres))
    got = fused.render_image_fused(sc, program.camera(cfg, rcfg), rcfg, SEED, spp=4,
                                   plain=True).reshape(-1, 3)
    w, h = cfg["resolution"]
    flat = torch.arange(w * h)
    frame = camera_frame(cfg["camera"], w / h)

    def ref(dtype):
        return spheres.render_pixels(spheres.SphereScene(cfg["scene"]).to("cpu", dtype), frame,
                                     check.reference_config(cfg), SEED, flat % w,
                                     h - 1 - flat // w, 4, dtype=dtype)

    spec = manifest.traffic("fused_500spp")["check"]
    want = ref(torch.float32)
    assert check.mismatch_share(got, want, spec)["value"] <= spec["limit"]
    low = check.mismatch_share(ref(torch.bfloat16), want, spec)
    assert low["value"] > low["limit"]


def test_the_manifest_finds_the_cell_as_files():
    listing = manifest.listing()
    assert "rtiow_final_1200" in listing["configs"]
    assert "fused_500spp" in listing["traffic"]
    assert "fused_spheres" in listing["entries"]
    new = ("k3_ms_per_request.rtiow", "k3_roofline.rtiow", "mfu.rtiow", "idle_share.rtiow",
           "sphere_tree_build_s")
    assert set(new) <= set(listing["metrics"])
    bench = manifest.benchmark()
    cell = manifest.workload(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("rtiow_final_1200",
                                                                "fused_500spp", 1)
    per = {m["name"] for m in manifest.metrics_of(bench, CELL, "per_layer")}
    assert per == set(new)
    e2e = {m["name"] for m in manifest.metrics_of(bench, CELL, "end_to_end")}
    assert e2e == {"paths_per_s", "setup_s"}
    traffic = manifest.traffic("fused_500spp")
    assert (traffic["spp_per_request"], traffic["trace_skip"], traffic["trace_requests"]) == (
        500, 1, 2)
    assert manifest.entry("fused_spheres").KERNELS == {"k3": "fused_path_kernel"}
    data = manifest.metric_data("k3_roofline.rtiow")
    assert set(data) == {"ops_per_path", "bytes_per_path", "peak_flops", "peak_bytes_per_s",
                         "derivation"}


def one_run(capsys, monkeypatch, fault=None):
    from benchmark import faults

    # This process's conftest loads JAX for the JAX package's tests; a run in
    # a process of its own is held to loading none (benchmark/tests/
    # test_bench_imports.py).
    monkeypatch.setattr(run, "loaded_forbidden", lambda: [])
    entry = manifest.entry("fused_spheres")
    traffic = dict(spp_per_request=2,
                   check=dict(manifest.traffic("fused_500spp")["check"], requests=2, pixels=48))
    argv = ["--workload", CELL, "--seed", str(SEED), "--seconds", "0", "--trace", "0"]
    with faults.plant(entry, fault) if fault else torch.no_grad():
        rc = run.main(argv, device="cpu", config_over=dict(resolution=[24, 16]),
                      traffic_over=traffic)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [None, "half_samples", "answer_altered", "stale_answer"])
def test_the_cell_under_fault(capsys, monkeypatch, fault):
    res = one_run(capsys, monkeypatch, fault)
    assert res["correct"] is (fault is None), res["checks"]
    if fault is None:
        assert set(res["metrics"]) == {"paths_per_s", "setup_s"}
