"""raytracer_tpu_torch.probes.morph ≡ scripts/kernel_morph.py.

For each of the script's 13 variants, its own run_variant runs unchanged,
with `jax.experimental.pallas.pallas_call` wrapped to run in interpret mode
and to record the kernel's outputs (`jax.jit` is left alone), and
`raytracer_tpu.scene.builder.reference_scene` returning the small 4-wide
tree of tests/probe_scripts.py (stack bound 16) as the scene's bvh4. The
port's plain version (the twin of csrc/probe_morph.cuh;
tests/test_torch_cuda.py holds the kernel to it on the card), fed the
same v5 tables and the script's 8 packets of rays from default_rng(3),
equals the recorded outputs: t and the normals within the tolerance of
tests/probe_scripts.py, the ids and materials exactly, the hit count of
the script's line exactly."""

import types

import numpy as np
import pytest
import torch
from probe_scripts import agree, jax_tree, load_script, record_pallas, small_tree

from raytracer_tpu.scene import builder as jbuilder
from raytracer_tpu_torch.probes import morph

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree():
    bvh = small_tree()
    return bvh, jax_tree(bvh), morph.tables_inputs(bvh)


@pytest.mark.parametrize("variant", list(morph.VARIANTS))
def test_morph_variant_matches_script(monkeypatch, tree, variant):
    bvh, jbvh, inputs = tree
    mod = load_script(monkeypatch, "kernel_morph.py", [])
    monkeypatch.setattr(jbuilder, "reference_scene",
                        lambda *a, **k: types.SimpleNamespace(bvh4=jbvh))
    calls = record_pallas(monkeypatch)
    line = mod.run_variant(variant)
    assert len(calls) == 1
    want = calls[0][1]
    node, tri, n_brute, cap, o, d, tlim = inputs
    assert cap == bvh.stack_depth == 16 and n_brute == 1
    *got, pk = morph.morph(node, tri, o, d, tlim, n_brute, cap, variant)
    assert len(got) == len(want) == morph.VARIANTS[variant][1]
    for g, w in zip(got, want):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            agree(g.numpy(), w)
    assert line == f"ok hit={morph.hits(got[0])}/{got[0].numel()}"
    loop = morph.VARIANTS[variant][0]
    if loop in ("fori", "whilecounter"):
        assert pk.tolist() == [morph.ITERS] * morph.N_PACKETS
    else:
        assert 0 < int(pk.min()) and int(pk.max()) < morph.MAX_ITERS
        assert loop == "while" or int(pk.max()) <= morph.ITERS


def test_morph_plain_guards_and_entry_point(tree, capsys):
    """A push beyond a chain's stack raises; an unknown variant raises; the
    entry point's in-process variant prints the script's line on the CPU."""
    _, _, (node, tri, n_brute, cap, o, d, tlim) = tree
    with pytest.raises(ValueError, match="stack"):
        morph.morph_plain(node, tri, o[:1], d[:1], tlim[:1], n_brute, 4, "v5_noclamp")
    with pytest.raises(ValueError, match="unknown variant"):
        morph.morph_plain(node, tri, o, d, tlim, n_brute, cap, "v12")
    # A capped while loop stops there, and the clamped / unclamped pushes agree
    # where no walk reaches the clamp.
    *cut, pk = morph.morph_plain(node, tri, o, d, tlim, n_brute, cap, "v5_noclamp", max_iters=3)
    assert pk.tolist() == [3] * morph.N_PACKETS
    full_c = morph.morph_plain(node, tri, o, d, tlim, n_brute, cap, "v4_brute")
    full_n = morph.morph_plain(node, tri, o, d, tlim, n_brute, cap, "v5_noclamp")
    assert all(torch.equal(a, b) for a, b in zip(full_c, full_n))
    assert not torch.equal(cut[0], full_n[0])
    assert morph.main(["v0_ablate", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("ok hit=")
