"""Helpers of tests/test_torch_probes*.py: the probe scripts of scripts/
imported as they are, the v5 tables of a small tree (and its fields as the
scripts' `scene.bvh4`), pallas_call recorded in interpret mode, and the
tolerance the outputs are held to.

The scripts read sys.argv at import (ITERS, and the packet count of
kernel_ablate_v8.py), so argv is patched first; kernel_ablate_v8.py calls
jaxcache.enable() at import, which is stubbed.

Tolerance: the port's plain version and the script's kernel in interpret
mode agree except where XLA's CPU contraction of multiply-adds flips a
near-tie (tests/test_torch_traverse.py:66): at most 0.5% of elements
beyond 1e-4·|x| + 1e-6 (NaN equals NaN)."""

import importlib.util
import os
import sys
import types

import numpy as np

from raytracer_tpu.utils import jaxcache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Tracing dominates the cost of an interpret-mode run; 6 iterations reach
# the stacks' pops at the same cost as 2.
PACKETS, ITERS = 2, 6
BAD_FRAC, RTOL, ATOL = 0.005, 1e-4, 1e-6


def load_script(monkeypatch, name: str, argv):
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in argv])
    monkeypatch.setattr(jaxcache, "enable", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(f"_probe_{name[:-3]}",
                                                  os.path.join(ROOT, "scripts", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_tree():
    """A small 4-wide tree: 400 random triangles and 4 large ones, which the
    builder splits off as brute rows."""
    import torch

    from raytracer_tpu_torch.scene.builder import build_scene_bvh4, tree_width
    from raytracer_tpu_torch.scene.types import TriMesh

    rng = np.random.default_rng(11)
    n_small = 400
    c = rng.uniform(-0.3, 0.3, (n_small, 1, 3))
    small = c + rng.normal(scale=0.06, size=(n_small, 3, 3))
    big = np.array([[[-1, -1, -0.5], [1, -1, -0.5], [0, 1, -0.5]],
                    [[-1, -1, 0.5], [0, 1, 0.5], [1, -1, 0.5]],
                    [[-1, -0.4, -1], [1, -0.4, -1], [0, -0.4, 1]],
                    [[-0.5, -1, -1], [-0.5, 1, -1], [-0.5, 0, 1]]])
    verts = np.concatenate([small, big]).reshape(-1, 3).astype(np.float32)
    n = verts.shape[0] // 3
    mesh = TriMesh(vertices=torch.from_numpy(verts),
                   faces=torch.arange(3 * n, dtype=torch.int32).reshape(n, 3),
                   face_mat=torch.from_numpy((np.arange(n) % 3).astype(np.int32)))
    with tree_width(4):
        bvh = build_scene_bvh4(mesh)
    assert bvh.children.shape[1] == 4 and bvh.brute_tri is not None
    return bvh


def v5_tables():
    """(node, tri, o, d, tlim, zero_row) as numpy: the v5 tables of the
    small tree and 2 packets of seeded rays. The node table is padded with
    zero rows to 251, the rows no_scalar's task walks through
    (0..1000 // 4)."""
    from raytracer_tpu_torch.probes import v5_body
    from raytracer_tpu_torch.probes.v5_tables import pack_tables

    bvh = small_tree()
    node, tri, _, n_brute = pack_tables(bvh, bvh.face_mat)
    assert n_brute == 1 and bvh.stack_depth + 4 <= v5_body.STACK_CAP
    node = np.concatenate([node.numpy(), np.zeros((251 - node.shape[0], 128), np.float32)])
    o, d, tlim = v5_body.make_rays(PACKETS, seed=2)
    return node, tri.numpy(), o, d, tlim, tri.shape[0] - 1


def agree(got, want) -> int:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    both_nan = np.isnan(got) & np.isnan(want)
    bad = ~both_nan & ~(np.abs(got - want) <= ATOL + RTOL * np.abs(want))
    assert bad.mean() <= BAD_FRAC, f"{bad.sum()} of {bad.size} elements differ"
    return int(bad.sum())


def jax_tree(bvh):
    """The fields of a port Bvh4 that the scripts read, as jnp arrays on a
    namespace (what the scripts take as `scene.bvh4`)."""
    import jax.numpy as jnp

    fields = ("bounds", "children", "tri", "prim_index", "face_mat", "brute_tri", "brute_prim",
              "brute_mat")
    return types.SimpleNamespace(**{f: jnp.asarray(getattr(bvh, f).numpy()) for f in fields},
                                 stack_depth=bvh.stack_depth)


def record_pallas(monkeypatch):
    """pl.pallas_call in interpret mode, each call's (inputs, outputs) as
    lists of numpy arrays appended to the returned list (through
    jax.debug.callback, so under jax.jit too)."""
    import jax
    from jax.experimental import pallas as pl

    calls = []
    real = pl.pallas_call

    def recording(kernel, **kw):
        fn = real(kernel, interpret=True, **kw)

        def run(*args):
            out = fn(*args)
            flat = list(out) if isinstance(out, (list, tuple)) else [out]
            n = len(args)
            jax.debug.callback(lambda *xs: calls.append(([np.asarray(x) for x in xs[:n]],
                                                         [np.asarray(x) for x in xs[n:]])),
                               *args, *flat)
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", recording)
    return calls
