"""raytracer_tpu_torch.probes.v6 ≡ scripts/kernel_v6_probe.py.

The port's v6 tables equal the script's `pack_tables_v6` bitwise on the
reference scene's 4-wide tree. The port's plain version (the twin of
csrc/probe_v6.cu; tests/test_torch_cuda.py holds the kernel to it on the
card) is fed the same inputs as the script's `traverse_v6` run through
`pl.pallas_call(..., interpret=True)`, on a small 4-wide tree over 2
packets, and held to the tolerance of tests/probe_scripts.py; then to the
port's own trace_closest by the script's rule (t within rtol 1e-5; ids,
materials and hits equal)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from probe_scripts import PACKETS, agree, load_script, small_tree

from raytracer_tpu.scene import builder as jbuilder
from raytracer_tpu_torch.convert import scene_from_numpy, to_numpy_tree
from raytracer_tpu_torch.ops.cuda_traverse import trace_closest
from raytracer_tpu_torch.probes import v5_body, v6
from raytracer_tpu_torch.probes.v6_tables import pack_tables_v6

torch.set_num_threads(2)


def test_pack_tables_v6_equals_script(monkeypatch):
    """v6_tables.pack_tables_v6 ≡ the script's on the reference scene built
    4-wide: node rows (leaf codes as triangle rows), the triangle table and
    the row counts."""
    mod = load_script(monkeypatch, "kernel_v6_probe.py", [])
    monkeypatch.setenv("RAYTRACER_TPU_BVH_WIDTH", "4")
    js = jbuilder.reference_scene("assets/models")
    ts = scene_from_numpy(to_numpy_tree(js))
    jn, jt, jl, jb = mod.pack_tables_v6(js.bvh4, js.bvh4.face_mat)
    tn, tt, tl, tb = pack_tables_v6(ts.bvh4, ts.bvh4.face_mat)
    for a, b in ((tn, jn), (tt, jt)):
        assert a.dtype == torch.float32 and tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (tl, tb) == (int(jl), int(jb)) and tb == 4
    codes = tn[:, 24:28]
    assert (codes <= -2).any() and int(-codes.min()) - 2 < tl
    with pytest.raises(ValueError, match="4-wide"):
        pack_tables_v6(types.SimpleNamespace(bounds=np.zeros((1, 8, 6), np.float32)), None)


def _inputs(limits: str):
    bvh = small_tree()
    node, tri, _, n_brute = pack_tables_v6(bvh, bvh.face_mat)
    o, d, tlim = v5_body.make_rays(PACKETS, seed=2)
    if limits == "varied":
        tlim = np.random.default_rng(6).uniform(0.05, 0.6, tlim.shape).astype(np.float32)
    return bvh, node, tri, n_brute, bvh.stack_depth + 4, o, d, tlim


@pytest.mark.parametrize("limits", ["big", "varied"])
def test_v6_plain_matches_script(monkeypatch, limits):
    """All six outputs of the plain version ≡ the script's kernel in
    interpret mode, at tlim = BIG and at limits seeded in (0.05, 0.6)."""
    mod = load_script(monkeypatch, "kernel_v6_probe.py", [])
    bvh, node, tri, n_brute, cap, o, d, tlim = _inputs(limits)
    want = mod.traverse_v6(jnp.asarray(node.numpy()), jnp.asarray(tri.numpy()), jnp.asarray(o),
                           jnp.asarray(d), jnp.asarray(tlim), stack_cap=cap,
                           n_brute_rows=n_brute, interpret=True)
    got = v6.v6(node, tri, *(torch.from_numpy(a) for a in (o, d, tlim)), n_brute, cap)
    for g, w in zip(got, want):
        agree(g.numpy(), np.asarray(w))
    assert (got[1] >= 0).float().mean() > 0.5


def test_v6_plain_matches_trace_closest():
    """The script's rule against K4 (here the port's trace_closest, plain)
    on the same tree: no mismatch; and the chains' iteration counts."""
    bvh, node, tri, n_brute, cap, o, d, tlim = _inputs("big")
    o, d, tlim = (torch.from_numpy(a) for a in (o, d, tlim))
    *out, iters = v6.v6(node, tri, o, d, tlim, n_brute, cap, count=True)
    ref = trace_closest(v6.unpack(o), v6.unpack(d), bvh, float(v6.BIG), sort=False)
    mis = v6.against_k4(out, ref)
    assert (mis["t"], mis["tri"], mis["mat"], mis["hit"]) == (0, 0, 0, 0), mis
    assert mis["hits"] > mis["n"] // 2
    assert iters.shape == (PACKETS, 8) and int(iters.min()) > 0
    assert int(iters.max()) < v6.default_max_iters(node, tri, n_brute)
    # A cut loop stops every chain at the cap and leaves some rays unfinished.
    *cut, cut_iters = v6.v6(node, tri, o, d, tlim, n_brute, cap, max_iters=3, count=True)
    assert int(cut_iters.max()) == 3 and v6.against_k4(cut, ref)["hit"] > 0
