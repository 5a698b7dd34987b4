"""The chain-width redesign of P-morph and P-interleave (csrc/probe_morph.cuh,
csrc/probe_interleave.cu): a `while` chain that loops on its own to its own
end gives the packet loop's outputs and counts; the W each entry point
picks from the packets (and G) and the card's SM count; the refusal of a W
no kernel is built for; and the plain versions' independence of W. The
kernels themselves run only on the card (tests/test_torch_cuda.py, marker
`cuda`)."""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.probes import common, interleave_probe, morph, sass, v5_body

H100_SMS = 132
WHILE_VARIANTS = [v for v, spec in morph.VARIANTS.items() if spec[0] == "while"]


@pytest.fixture(scope="module")
def ref_inputs():
    return morph.reference_inputs(morph.N_PACKETS)


def own_loops(node, tri, o, d, tlim, nb, cap, variant, max_iters=morph.MAX_ITERS):
    """morph_plain's steps with each `while` chain looping on its own, as
    the kernel runs it: a chain runs while its task is not NONE and it has
    run fewer than max_iters iterations, whatever its packet's other
    chains do; the other loops run the packet loop. (outputs, packet
    counts, live iterations) as morph_plain(live=True)."""
    c = morph.plain_start(node, tri, o, d, tlim, nb, cap, variant, max_iters=max_iters)

    def running():
        if c.loop == "while":
            return (c.task != morph.NONE) & (c.chain_it < max_iters)
        return morph.plain_running(c)

    act = running()
    while bool(act.any()):
        morph.plain_step(c, act)
        act = running()
    return morph.plain_result(c, live=True)


def _random_set(ref_inputs):
    """Three of the script's packets at limits seeded in (0.001, 0.05): the
    root test leaves some chains at NONE and the walks end early and
    unevenly (2-32 iterations)."""
    node, tri, nb, cap, o, d, tlim = ref_inputs
    tl = torch.from_numpy(np.random.default_rng(11).uniform(
        0.001, 0.05, (3, *tlim.shape[1:])).astype(np.float32))
    return node, tri, nb, cap, o[:3], d[:3], tl


@pytest.mark.parametrize("inputs", ["script", "random", "capped"])
@pytest.mark.parametrize("variant", WHILE_VARIANTS)
def test_while_chains_on_their_own_equal_the_packet_loop(ref_inputs, variant, inputs):
    """Each chain looping to its own end (or max_iters) gives the packet
    loop's outputs bit for bit and, as the largest of its chains' counts,
    the packet's loop count: the script's 8 packets, a random set, and a
    loop cut at max_iters = 30."""
    node, tri, nb, cap, o, d, tlim = (ref_inputs if inputs != "random"
                                      else _random_set(ref_inputs))
    if inputs == "capped":
        o, d, tlim = o[:2], d[:2], tlim[:2]
    max_iters = 30 if inputs == "capped" else morph.MAX_ITERS
    packet = morph.morph_plain(node, tri, o, d, tlim, nb, cap, variant, max_iters=max_iters,
                               live=True)
    own = own_loops(node, tri, o, d, tlim, nb, cap, variant, max_iters=max_iters)
    assert len(packet) == len(own) == morph.VARIANTS[variant][1] + 2
    assert all(torch.equal(a, b) for a, b in zip(packet, own))
    pk, live = packet[-2], packet[-1]
    # The packet's count is its longest chain's; every live iteration is
    # one a chain began at a task, so no chain has more than its packet.
    assert torch.equal(pk, live.max(1).values.clamp_max(max_iters))
    if inputs == "capped":
        assert pk.tolist() == [30, 30]
    else:
        assert int(live.sum()) < morph.P_SUB * int(pk.sum())
    if inputs == "random" and morph.VARIANTS[variant][2] == "root":
        assert int((live == 0).sum()) > 0   # chains the root test left at NONE


def test_live_iterations_of_the_script_run(ref_inputs):
    """The script's 8 packets under v1_while: loops of 80-151 iterations,
    7,280 chain-iterations of the packet loop, 4,078 of them live (56%):
    the work morph.work counts."""
    node, tri, nb, cap, o, d, tlim = ref_inputs
    *_, pk, live = morph.morph_plain(node, tri, o, d, tlim, nb, cap, "v1_while", live=True)
    assert (int(pk.min()), int(pk.max())) == (80, 151)
    assert morph.P_SUB * int(pk.sum()) == 7280 and int(live.sum()) == 4078
    w = morph.work(node, tri, o, "v1_while", int(live.sum()), nb)
    assert w["ops"] == 4078 * (8 * common.MT_OPS + 4 * common.SLAB_OPS) * 128


@pytest.mark.parametrize("variant", ["v0_ablate", "v7_whilealive_cap", "v9_cap_rootinit"])
def test_restarting_loops_are_live_but_for_a_dead_start(ref_inputs, variant):
    """The loops that restart a finished walk at the root run live every
    iteration, except a chain the root test starts at NONE, whose first
    iteration is dead; own_loops() changes nothing there."""
    node, tri, nb, cap, o, d, tlim = _random_set(ref_inputs)
    *outs, pk, live = morph.morph_plain(node, tri, o, d, tlim, nb, cap, variant, live=True)
    *outs2, pk2, live2 = own_loops(node, tri, o, d, tlim, nb, cap, variant)
    assert torch.equal(pk, pk2) and torch.equal(live, live2)
    assert all(torch.equal(a, b) for a, b in zip(outs, outs2))
    full = pk[:, None].expand_as(live)
    assert bool(((full - live) <= (1 if morph.VARIANTS[variant][2] == "root" else 0)).all())


MORPH_W = [(8, H100_SMS, 4), (128, H100_SMS, 2), (1056, H100_SMS, 1),
           (8, 114, 4), (128, 114, 1), (1056, 114, 1)]


@pytest.mark.parametrize("packets, sms, want", MORPH_W)
def test_morph_picks_w_within_sixteen_warps_per_sm(packets, sms, want):
    """The loops that run every chain of a packet widen as the v5 body
    does: the script's 8 packets take W = 4 (W = 2 for the six-output
    capped variants, not built at 4), 1,056 (the card full) W = 1. A
    `while` chain, alone in its block, takes the widest W at any size."""
    for v, (loop, *_) in morph.VARIANTS.items():
        got = morph.chosen_w(packets, v, sms)
        if loop == "while":
            assert got == max(morph.ADMITTED_W[v]) == 4
        else:
            assert got == min(want, max(morph.ADMITTED_W[v])) == common.pick_w(
                packets, sms, morph.ADMITTED_W[v], v5_body.WARPS_PER_SM)


# (packets, SMs): W for G = 1, 2, 4, 8
INTERLEAVE_W = {(8, H100_SMS): (2, 4, 4, 4), (128, H100_SMS): (2, 4, 4, 4),
                (1056, H100_SMS): (2, 4, 4, 4), (8, 114): (2, 4, 4, 4),
                (128, 114): (2, 4, 4, 4), (1056, 114): (2, 4, 4, 4)}


@pytest.mark.parametrize("packets, sms", list(INTERLEAVE_W))
def test_interleave_picks_w_per_g(packets, sms):
    """P-interleave takes, at any packets and SMs, the widest W a G admits
    that leaves a thread two lanes or more: W = 2 at G = 1, else 4 (G = 8
    is not built at W = 1: 32 lanes per thread)."""
    got = tuple(interleave_probe.chosen_w(G) for G in interleave_probe.GS)
    assert got == INTERLEAVE_W[(packets, sms)]
    assert all(4 * G // w >= 2 and w in interleave_probe.ADMITTED_W[G]
               for G, w in zip(interleave_probe.GS, got))


def test_admitted_widths():
    capped6 = {"v8_cap_outs6", "v9_cap_rootinit", "v10_cap_brute", "v11_cap_noclamp"}
    assert set(morph.ADMITTED_W) == set(morph.VARIANTS)
    assert all(ws == ((1, 2) if v in capped6 else common.CHAIN_WIDTHS)
               for v, ws in morph.ADMITTED_W.items())
    assert interleave_probe.ADMITTED_W == {1: (1, 2, 4), 2: (1, 2, 4), 4: (1, 2, 4), 8: (2, 4)}


@pytest.mark.parametrize("w", [0, 3, 8, -1])
def test_unadmitted_w_raises(ref_inputs, w):
    """A W no kernel is built for raises before anything runs, on the CPU
    as on the card; so does G = 8 at W = 1."""
    node, tri, nb, cap, o, d, tlim = ref_inputs
    with pytest.raises(ValueError, match="chain width"):
        morph.morph(node, tri, o[:1], d[:1], tlim[:1], nb, cap, "v1_while", w=w)
    with pytest.raises(ValueError, match="chain width"):
        interleave_probe.interleave(node, tri, o[:1], d[:1], tlim[:1], tri.shape[0] - 1, 1, 2,
                                    w=w)
    with pytest.raises(ValueError, match="chain width"):
        interleave_probe.interleave(node, tri, o, d, tlim, tri.shape[0] - 1, 8, 2, w=1)


def test_plain_versions_take_any_admitted_w(ref_inputs):
    """On the CPU the wrappers run the plain versions, whose result no W
    (or G) changes."""
    node, tri, nb, cap, o, d, tlim = ref_inputs
    args = (node, tri, o[:1], d[:1], tlim[:1], nb, cap, "v3_rootinit")
    ref = morph.morph_plain(*args, iters=8, max_iters=12)
    for w in (None, *morph.ADMITTED_W["v3_rootinit"]):
        got = morph.morph(*args, iters=8, max_iters=12, w=w)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    zero_row = tri.shape[0] - 1
    ref_t = v5_body.v5_plain(node, tri, o[:4], d[:4], tlim[:4], zero_row, "full", 5)
    for G in (2, 4):
        for w in (None, *interleave_probe.ADMITTED_W[G]):
            got = interleave_probe.interleave(node, tri, o[:4], d[:4], tlim[:4], zero_row, G, 5,
                                              w=w)
            assert torch.equal(got, ref_t)


def test_sass_names_carry_the_chain_width():
    """cuobjdump names of the morph kernels with W (six template arguments)
    and of the interleave kernels (G, W) are parsed and named with their W;
    the parent's forms, without W, keep their names."""
    text = """
        Function : _ZN11probe_morph18probe_morph_kernelILi1ELb1ELb1ELb0ELb1ELi4EEEvPKfS2_S2_S2_S2_iiiiiPfPiS4_S3_S3_S3_S4_
        /*0000*/                   FADD R2, R3, R4 ;
        /*0010*/                   BAR.SYNC R5, R6 ;
        Function : _ZN11probe_morph18probe_morph_kernelILi2ELb0ELb0ELb0ELb1ELi1EEEvPKfS2_S2_S2_S2_iiiiiPfPiS4_S3_S3_S3_S4_
        /*0000*/                   LDS.128 R4, [R2] ;
        Function : _ZN16probe_interleave23probe_interleave_kernelILi8ELi2EEEvPKfS2_S2_S2_S2_iiPf
        /*0000*/                   SHFL.BFLY PT, R1, R2, 0x1, 0x1f ;
        Function : _ZN16probe_interleave23probe_interleave_kernelILi4EEEvPKfS2_S2_S2_S2_iiPf
        /*0000*/                   FMUL R1, R2, R3 ;
    """
    c = sass.parse(text)
    assert set(c) == {("morph", ((1, 1, 1, 0, 1), 4)), ("morph", ((2, 0, 0, 0, 1), 1)),
                      ("interleave", (8, 2)), ("interleave", 4)}
    assert c[("morph", ((1, 1, 1, 0, 1), 4))]["sync"] == 1
    assert c[("interleave", (8, 2))]["shfl"] == 1
    assert {sass.name(*k) for k in c} == {"morph v3_rootinit W4", "morph v6_whilecounter W1",
                                          "interleave G8 W2", "interleave G4"}


def test_sass_splits_a_kernel_by_loop():
    """sass.loops: two loops (a pre-pass, then the walk, whose latch is an
    unconditional branch back), the code outside them up to the exit, and
    a cold block after the exit that branches back into the walk, which is
    not a loop."""
    text = """
        Function : _ZN11probe_morph18probe_morph_kernelILi1ELb1ELb1ELb1ELb1ELi1EEEvPKfS2_S2_S2_S2_iiiiiPfPiS4_S3_S3_S3_S4_
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FADD R2, R3, R4 ;
        /*0020*/                   FADD R2, R3, R4 ;
        /*0030*/               @P0 BRA 0x20 ;
        /*0040*/                   NOP ;
        /*0050*/                   IADD3 R2, R3, R4, RZ ;
        /*0060*/                   FMUL R2, R3, R4 ;
        /*0070*/               @P1 BRA 0xa0 ;
        /*0080*/                   FMUL R2, R3, R4 ;
        /*0090*/                   BRA 0x60 ;
        /*00a0*/                   STG.E [R2.64], R4 ;
        /*00b0*/                   EXIT ;
        /*00c0*/                   BPT.TRAP 0x1 ;
        /*00d0*/                   BRA 0x80 ;
        /*00e0*/                   BRA 0xe0 ;
    """
    c = sass.parse(text)[("morph", ((1, 1, 1, 1, 1), 1))]
    assert c["total"] == 14
    assert c["loops"] == [2, 4]              # 0x20-0x30; 0x60-0x90
    assert c["straight"] == 5                # 0x00, 0x10, 0x50, 0xa0, 0xb0
    assert sass.loops([]) == ([], 0)


def test_sass_loop_min_takes_the_shortest_path_through_a_loop():
    """sass.loop_min: a branch forward inside the body skips its block (the
    shorter path counts), a branch out of the loop is not taken, a branch
    back inside the body is passed once; the main loop unrolled with a
    remainder loop gives the remainder's single pass as the least."""
    text = """
        Function : _ZN8probe_v514probe_v5_kernelILi0ELi1EEEvPKfS1_S1_S1_S1_iiiiPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FADD R2, R3, R4 ;
        /*0020*/               @P0 BRA 0x60 ;
        /*0030*/                   FMUL R2, R3, R4 ;
        /*0040*/                   FMUL R2, R3, R4 ;
        /*0050*/                   FMUL R2, R3, R4 ;
        /*0060*/                   FADD R2, R3, R4 ;
        /*0070*/                   FADD R5, R3, R4 ;
        /*0080*/               @P2 BRA 0x70 ;
        /*0090*/               @P1 BRA 0x100 ;
        /*00a0*/               @P3 BRA 0x10 ;
        /*00b0*/                   IADD3 R2, R3, R4, RZ ;
        /*00c0*/               @P4 BRA 0xb0 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   BRA 0xe0 ;
    """
    c = sass.parse(text)[("v5", (0, 1))]
    assert c["loops"] == [10, 2]           # 0x10-0xa0 (with 0x70-0x80 inside); 0xb0-0xc0
    assert c["loop_min"] == [7, 2]         # 0x10, 0x20 (taken), 0x60-0xa0; 0xb0, 0xc0
    assert sass.loop_min([]) == []
