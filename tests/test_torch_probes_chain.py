"""The chain width of P-v8 and the v5 body (csrc/probe_v8.cuh,
csrc/probe_v5.cuh): the host-side choice of W from the packets and the
card's SM count, the refusal of a W no kernel is built for, and the plain
versions' independence of W. The kernels themselves run only on the card
(tests/test_torch_cuda.py, marker `cuda`)."""

import pytest
import torch

from raytracer_tpu_torch.probes import ablate_v8, common, sass, v5_body

H100_SMS = 132


@pytest.mark.parametrize("packets, sms, want", [
    (1, H100_SMS, 4), (64, H100_SMS, 4), (66, H100_SMS, 4),   # 66 x 8 x 4 = 16 x 132 warps
    (67, H100_SMS, 2), (128, H100_SMS, 2), (132, H100_SMS, 2),
    (133, H100_SMS, 1), (264, H100_SMS, 1), (1056, H100_SMS, 1),
    (1, 1, 2), (2, 1, 1), (0, H100_SMS, 4), (64, 114, 2), (57, 114, 4),
])
def test_pick_w_widest_within_sixteen_warps_per_sm(packets, sms, want):
    """The widest W whose packets x 8 x W warps stay within 16 per SM (the
    v5 body's target), else 1: its scripts' 128 packets take W = 2 on an
    H100's 132 SMs, 1,056 (the card full) W = 1."""
    assert v5_body.WARPS_PER_SM == 16
    assert common.pick_w(packets, sms, common.CHAIN_WIDTHS, v5_body.WARPS_PER_SM) == want
    assert common.pick_w(packets, sms, (1,), v5_body.WARPS_PER_SM) == 1


@pytest.mark.parametrize("packets, want", [(1, 4), (33, 4), (34, 2), (64, 2), (66, 2),
                                           (67, 1), (1056, 1)])
def test_pick_w_v8_within_eight_warps_per_sm(packets, want):
    """P-v8 widens up to 8 warps per SM (33 x 8 x 4 = 1,056 = 8 x 132): its
    script's 64 packets take W = 2, where W = 2 measured faster than 4."""
    assert ablate_v8.WARPS_PER_SM == 8
    assert common.pick_w(packets, H100_SMS, ablate_v8.ADMITTED_W, ablate_v8.WARPS_PER_SM) == want


@pytest.mark.parametrize("admitted, want", [((1, 2), 2), ((1, 4), 4), ((1,), 1),
                                            ((1, 2, 4), 4)])
def test_pick_w_takes_only_admitted_widths(admitted, want):
    assert common.pick_w(64, H100_SMS, admitted, v5_body.WARPS_PER_SM) == want


def test_admitted_widths():
    assert ablate_v8.ADMITTED_W == common.CHAIN_WIDTHS == (1, 2, 4)
    assert set(v5_body.ADMITTED_W) == set(v5_body.MODES)
    assert all(1 in ws and set(ws) <= {1, 2, 4} for ws in v5_body.ADMITTED_W.values())


@pytest.mark.parametrize("w", [0, 3, 8, -1])
def test_unadmitted_w_raises(w):
    """A W no kernel is built for raises before anything runs, on the CPU
    as on the card: the entry point never takes another W."""
    node, tri, o, d = (torch.from_numpy(a) for a in ablate_v8.make_inputs(1))
    with pytest.raises(ValueError, match="chain width"):
        ablate_v8.ablate_v8(node, tri, o, d, "full", 2, w=w)
    o5, d5, tl5 = (torch.from_numpy(a) for a in v5_body.make_rays(1))
    with pytest.raises(ValueError, match="chain width"):
        v5_body.v5(node, tri, o5, d5, tl5, 0, "full", 2, w=w)


def test_plain_versions_take_any_admitted_w():
    """On the CPU the wrappers run the plain versions, whose result no W
    changes."""
    node, tri, o, d = (torch.from_numpy(a) for a in ablate_v8.make_inputs(1))
    ref = ablate_v8.ablate_v8_plain(node, tri, o, d, "full", 3)
    for w in (None, *ablate_v8.ADMITTED_W):
        assert torch.equal(ablate_v8.ablate_v8(node, tri, o, d, "full", 3, w=w), ref)


def test_sass_names_carry_the_chain_width():
    """cuobjdump names of the two-argument kernels (variant or mode, W) are
    parsed and named with their W; one-argument names keep their form."""
    text = """
        Function : _ZN8probe_v815probe_v8_kernelILi0ELi4EEEvPKfS2_S2_S2_iiiPf
        /*0000*/                   FADD R2, R3, R4 ;
        /*0010*/                   BAR.SYNC R5, R6 ;
        Function : _ZN8probe_v515probe_v5_kernelILi13ELi2EEEvPKfS2_S2_S2_S2_iiPf
        /*0000*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        Function : _ZN8probe_v515probe_v5_kernelILi12EEEvPKfS2_S2_S2_S2_iiPf
        /*0000*/                   FMUL R1, R2, R3 ;
    """
    c = sass.parse(text)
    assert set(c) == {("v8", (0, 4)), ("v5", (13, 2)), ("v5", 12)}
    assert (c[("v8", (0, 4))]["total"], c[("v8", (0, 4))]["sync"]) == (2, 1)
    assert c[("v5", (13, 2))]["global"] == 1
    assert {sass.name(*k) for k in c} == {"v8 full W4", "v5 base W2", "v5 prod_carry"}
