"""raytracer_tpu_torch.probes ≡ the probe scripts of scripts/: the v5
tables and the 4-wide tree they need, and the v8 ablation
(tests/test_torch_probes_v5.py holds the three v5-body probes).

Each probe's plain version (the CUDA kernel's twin; tests/test_torch_cuda.py
holds the kernels to it on the card) is fed the same numpy inputs as the
script's own `make_kernel`, run through `pl.pallas_call(..., interpret=True)`
with the script's in/out specs, at a tiny size: 2 packets and 6 iterations.
The scripts are imported unedited and the outputs held to the tolerance of
tests/probe_scripts.py: at most 0.5% of elements beyond 1e-4·|x| + 1e-6,
for XLA's CPU contraction of multiply-adds."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from probe_scripts import ITERS, PACKETS, agree, load_script

from raytracer_tpu.ops.pallas_traverse import _pack_tables, _select_record
from raytracer_tpu.scene import builder as jbuilder
from raytracer_tpu_torch.convert import scene_from_numpy, to_numpy_tree
from raytracer_tpu_torch.probes import ablate_v8, sass, v5_tables
from raytracer_tpu_torch.scene import builder as tbuilder

torch.set_num_threads(2)

# ---- the v5 tables and the 4-wide tree ---------------------------------

BVH_FIELDS = ("bounds", "children", "tri", "prim_index", "face_mat",
              "brute_tri", "brute_prim", "brute_mat")


def test_width4_tree_equals_jax_builder(monkeypatch):
    """RAYTRACER_TPU_BVH_WIDTH=4: the port's reference-scene tree equals
    the JAX builder's bitwise, and is 4 wide."""
    monkeypatch.setenv("RAYTRACER_TPU_BVH_WIDTH", "4")
    jb = jbuilder.reference_scene("assets/models").bvh4
    tb = tbuilder.reference_scene().bvh4
    for f in BVH_FIELDS:
        a, b = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tb.children.shape[1] == 4 and tb.stack_depth == jb.stack_depth


def test_v5_tables_equal_pack_tables(monkeypatch):
    """v5_tables.pack_tables ≡ pallas_traverse._pack_tables bitwise on the
    reference scene's 4-wide tree (brute rows and trailing zero row
    included), and select_record ≡ _select_record."""
    monkeypatch.setenv("RAYTRACER_TPU_BVH_WIDTH", "4")
    js = jbuilder.reference_scene("assets/models")
    ts = scene_from_numpy(to_numpy_tree(js))
    jn, jt, jl, jbr = _pack_tables(js.bvh4, js.bvh4.face_mat)
    tn, tt, tl, tbr = v5_tables.pack_tables(ts.bvh4, ts.bvh4.face_mat)
    for a, b in ((tn, jn), (tt, jt)):
        assert a.dtype == torch.float32 and tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (tl, tbr) == (int(jl), int(jbr)) and tbr == 4
    assert tn.shape[0] == -(-ts.bvh4.children.shape[0] // 4)
    rows = np.random.default_rng(3).normal(size=(6, 128)).astype(np.float32)
    for sub in range(4):
        want = np.concatenate([np.asarray(_select_record(jnp.asarray(r[None]), sub, 4, 32))
                               for r in rows])
        got = v5_tables.select_record(torch.from_numpy(rows), torch.full((6,), sub), 4, 32)
        np.testing.assert_array_equal(got.numpy(), want)
    wide = types.SimpleNamespace(bounds=np.zeros((1, 8, 6), np.float32),
                                 children=np.zeros((1, 8), np.int32),
                                 tri=np.zeros((8, 9), np.float32))
    with pytest.raises(ValueError, match="4-wide"):
        v5_tables.pack_tables(wide, np.zeros(8, np.int32))


# ---- v8 ---------------------------------------------------------------

def _v8_inputs():
    rng = np.random.default_rng(5)
    n_nodes, n_trirows = 40, 56
    node = rng.normal(size=(n_nodes, 128)).astype(np.float32)
    codes = rng.integers(0, n_nodes, size=(n_nodes, 8)).astype(np.float32)
    codes[rng.random((n_nodes, 8)) < 0.4] *= -1
    node[:, 48:56] = codes
    tri = rng.normal(size=(n_trirows, 128)).astype(np.float32)
    o = rng.normal(size=(PACKETS, 3, 8, 128)).astype(np.float32)
    d = rng.normal(size=(PACKETS, 3, 8, 128)).astype(np.float32)
    d = np.where(np.abs(d) < 1e-3, 1e-3, d).astype(np.float32)
    return node, tri, o, d


@pytest.mark.parametrize("variant", ablate_v8.VARIANTS)
def test_ablate_v8_matches_script(monkeypatch, variant):
    mod = load_script(monkeypatch, "kernel_ablate_v8.py", [ITERS, PACKETS])
    node, tri, o, d = _v8_inputs()
    want = pl.pallas_call(
        mod.make_kernel(variant, node.shape[0], tri.shape[0]),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 4,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((PACKETS, 8, 128), jnp.float32),
        interpret=True)(node, tri, o, d)
    got = ablate_v8.ablate_v8(*(torch.from_numpy(a) for a in (node, tri, o, d)), variant, ITERS)
    agree(got.numpy(), want)
    assert np.isfinite(np.asarray(want)).all()


@pytest.mark.parametrize("variant", ["full", "no_reduce"])
def test_ablate_v8_nan_inputs_match_script(monkeypatch, variant):
    """NaN node bounds and zero direction components (1/d infinite, so a
    plane distance 0 · inf is NaN): the slab's NaN-is-miss rule gives the
    script's jnp.minimum/maximum results, NaN where those propagate it
    (no_reduce takes lane 0's NaN entry distance into t)."""
    mod = load_script(monkeypatch, "kernel_ablate_v8.py", [ITERS, PACKETS])
    node, tri, o, d = _v8_inputs()
    node[::7, 0:48:5] = np.nan
    node[::11, 3] = np.inf
    d[:, 0, :, ::9] = 0.0
    o[:, 0, :, ::9] = node[0, 0]
    want = pl.pallas_call(
        mod.make_kernel(variant, node.shape[0], tri.shape[0]),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 4,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((PACKETS, 8, 128), jnp.float32),
        interpret=True)(node, tri, o, d)
    got = ablate_v8.ablate_v8(*(torch.from_numpy(a) for a in (node, tri, o, d)), variant, ITERS)
    agree(got.numpy(), want)
    assert np.isnan(np.asarray(want)).any() == (variant == "no_reduce")


def test_sass_counts_parse():
    """probes.sass counts a probe kernel's instructions by kind from
    cuobjdump -sass text, predicated ones included, NOPs and other kernels
    not."""
    text = """
        Function : _ZN8probe_v815probe_v8_kernelILi3EEEvPKfS2_S2_S2_iiiPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FADD R2, R3, R4 ;
        /*0020*/              @!P0 SHFL.BFLY PT, R5, R2, 0x10, 0x1f ;
        /*0030*/                   LDS.U R6, [R7] ;
        /*0040*/                   NOP ;
        /*0050*/              @P1 BRA 0x20 ;
        Function : _Z20trace_closest_kernelN4trav7BvhViewEPKfS2_S2_fiPfPiS4_S3_
        /*0000*/                   FMUL R1, R2, R3 ;
        Function : _ZN8probe_v515probe_v5_kernelILi12EEEvPKfS2_S2_S2_S2_iiPf
        /*0000*/                   WARPSYNC 0xffffffff ;
        /*0010*/                   FSETP.GT.AND P0, PT, R1, R2, PT ;
    """
    c = sass.parse(text)
    assert set(c) == {("v8", 3), ("v5", 12)}
    v8 = c[("v8", 3)]
    assert (v8["total"], v8["fp32"], v8["shfl"], v8["shared"], v8["branch"]) == (5, 1, 1, 1, 1)
    v5 = c[("v5", 12)]
    assert (v5["total"], v5["sync"], v5["fp32"]) == (2, 1, 1)


def test_sass_counts_parse_new_probes():
    """The P-base, P-interleave, P-scalar and P-vstack kernels (and the
    scalar probe's tables pre-pass) are parsed and named in their probes'
    terms."""
    text = """
        Function : _ZN16probe_interleave23probe_interleave_kernelILi8EEEvPKfS2_S2_S2_S2_iiPf
        /*0000*/                   FADD R2, R3, R4 ;
        Function : _ZN12probe_scalar19probe_scalar_kernelILi4EEEvPKfPKiiPfPiS6_
        /*0000*/                   SHFL.IDX PT, R5, R2, RZ, 0x1f ;
        /*0010*/                   STS [R7], R6 ;
        Function : _ZN12probe_scalar26probe_scalar_tables_kernelEiiPi
        /*0000*/                   LDS R6, [R7] ;
        Function : _ZN12probe_vstack19probe_vstack_kernelILi1EEEviPiS1_Pf
        /*0000*/                   SHFL.UP PT, R5, R2, 0x1, RZ ;
        Function : _ZN8probe_v515probe_v5_kernelILi16EEEvPKfS2_S2_S2_S2_iiPf
        /*0000*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
    """
    c = sass.parse(text)
    assert set(c) == {("interleave", 8), ("scalar", 4), ("scalar", "tables"), ("vstack", 1),
                      ("v5", 16)}
    assert (c[("scalar", 4)]["shfl"], c[("scalar", 4)]["shared"]) == (1, 1)
    assert {sass.name(*k) for k in c} == {"interleave G8", "scalar vsort", "scalar tables",
                                          "v5 minimal", "vstack p2_vreg"}


def test_sass_counts_parse_ktf_v6():
    """The P-ktf kernels (one per case) and the P-v6 kernel are parsed and
    named in their probes' terms; the production kernels are not counted."""
    text = """
        Function : _ZN9probe_ktf16probe_ktf_kernelILi4EEEvPKiS2_jjPvS3_S3_S3_
        /*0000*/                   IADD3 R2, R3, R4, RZ ;
        /*0010*/                   MUFU.COS R5, R2 ;
        Function : _ZN8probe_v615probe_v6_kernelEPKfS1_S1_S1_S1_iiiiPfPiS3_S2_S2_S2_S3_
        /*0000*/                   SHFL.BFLY PT, R5, R2, 0x10, 0x1f ;
        /*0010*/                   STS [R7], R6 ;
        /*0020*/                   FSETP.GT.AND P0, PT, R1, R2, PT ;
        Function : _ZN2mk17fused_path_kernelILi4ELb0EEEv11FusedParamsN4trav7BvhViewEPKiS5_S5_
        /*0000*/                   FMUL R1, R2, R3 ;
    """
    c = sass.parse(text)
    assert set(c) == {("ktf", 4), ("v6", 0)}
    assert (c[("ktf", 4)]["int"], c[("ktf", 4)]["fp32"]) == (1, 1)
    assert (c[("v6", 0)]["total"], c[("v6", 0)]["shfl"], c[("v6", 0)]["shared"]) == (3, 1, 1)
    assert {sass.name(*k) for k in c} == {"ktf sampler_tile", "v6"}


def test_sass_counts_parse_tile_and_morph_probes():
    """The P-mosaic, P-feature and P-bitcast kernels (one per case) and the
    P-morph kernels (one per variant, named by their five template
    arguments) are parsed and named in their probes' terms."""
    text = """
        Function : _ZN12probe_mosaic19probe_mosaic_kernelILi1EEEvPKfPKiiPv
        /*0000*/                   SHFL.BFLY PT, R5, R2, 0x10, 0x1f ;
        Function : _ZN13probe_feature20probe_feature_kernelILi3EEEvPKfPKiiPfS5_S5_S5_S5_S5_
        /*0000*/                   BAR.RED.POPC RZ, 0x0, P0 ;
        Function : _ZN13probe_bitcast20probe_bitcast_kernelILi2EEEvPKfiPiS3_
        /*0000*/                   LDG.E R2, [R4.64] ;
        Function : _ZN11probe_morph18probe_morph_kernelILi3ELb1ELb1ELb1ELb0EEEvPKfS2_S2_S2_S2_iiiiiPfPiS4_S3_S3_S3_S4_
        /*0000*/                   FADD R2, R3, R4 ;
        Function : _ZN11probe_morph18probe_morph_kernelILi0ELb0ELb0ELb0ELb1EEEvPKfS2_S2_S2_S2_iiiiiPfPiS4_S3_S3_S3_S4_
        /*0000*/                   FADD R2, R3, R4 ;
    """
    c = sass.parse(text)
    assert {sass.name(*k) for k in c} == {"mosaic lanesum", "feature s4", "bitcast p3",
                                          "morph v11_cap_noclamp", "morph v0_ablate"}
    assert (c[("feature", 3)]["sync"], c[("bitcast", 2)]["global"]) == (1, 1)
