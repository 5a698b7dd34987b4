"""The chain redesign of P-v6 (csrc/probe_v6.cu) and the launch path of
P-ktf (csrc/probe_ktf.cu), on the CPU: each v6 chain looping on its own to
its own end gives the packet loop's outputs and counts; at stack_cap 12,
where the stall guard and the clamps fire, the plain version still equals
the script's traverse_v6 in interpret mode; the W `v6` picks from the
packets and the card's SM count; the refusal of a W no kernel is built
for; the plain version's independence of W; and P-ktf's wrapper: its
rules, its errors and its outputs. The kernels themselves run only on the
card (tests/test_torch_cuda.py, marker `cuda`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from probe_scripts import PACKETS, agree, load_script, small_tree

from raytracer_tpu_torch.probes import ktf_probe, v5_body, v6
from raytracer_tpu_torch.probes.v6_tables import pack_tables_v6
from raytracer_tpu_torch.utils import cudalib, ktf

torch.set_num_threads(2)
H100_SMS = 132


@pytest.fixture(scope="module")
def ref_inputs():
    """The script's tables and 8 packets of its rays: (node, tri, n_brute,
    stack_cap, o, d, tlim)."""
    _, node, tri, nb, cap, o, d, tlim = v6.reference_inputs(8)
    return node, tri, nb, cap, o, d, tlim


def small_inputs(seed: int = 2):
    """The small 4-wide tree's tables and PACKETS packets of rays."""
    bvh = small_tree()
    node, tri, _, nb = pack_tables_v6(bvh, bvh.face_mat)
    o, d, tlim = (torch.from_numpy(a) for a in v5_body.make_rays(PACKETS, seed=seed))
    return node, tri, nb, bvh.stack_depth + 4, o, d, tlim


def own_loops(node, tri, nb, cap, o, d, tlim, max_iters=None):
    """v6_plain's outputs and counts with each chain looping on its own, as
    the kernel runs it: chain (p, s) alone, its rays in all 8 chains of one
    packet, so that the loop runs exactly while that chain has work (or to
    max_iters) and no finished chain is stepped. Stacked as [P, 8, ...]."""
    P = o.shape[0]
    outs = [[None] * 8 for _ in range(P)]
    for p in range(P):
        for s in range(8):
            oc, dc = (x[p:p + 1, :, s:s + 1].expand(1, 3, 8, 128).contiguous() for x in (o, d))
            tc = tlim[p:p + 1, s:s + 1].expand(1, 8, 128).contiguous()
            got = v6.v6_plain(node, tri, oc, dc, tc, nb, cap, max_iters, count=True)
            outs[p][s] = [x[0, 0] for x in got]
    return tuple(torch.stack([torch.stack([outs[p][s][k] for s in range(8)]) for p in range(P)])
                 for k in range(7))


@pytest.mark.parametrize("inputs", ["script", "small", "capped"])
def test_v6_chains_on_their_own_equal_the_packet_loop(ref_inputs, inputs):
    """Each chain looping to its own end (or max_iters) gives the packet
    loop's six outputs bit for bit and its own iteration count: the script's
    8 packets, the small tree's 2, and 2 of the script's packets with the
    loop cut at max_iters = 40. A finished chain reads node row 0 and the
    zero triangle row, pushes nothing and pops nothing, so its later
    iterations in the packet loop change nothing."""
    if inputs == "small":
        args = small_inputs()
    else:
        args = ref_inputs if inputs == "script" else (*ref_inputs[:4],
                                                      *(x[:2] for x in ref_inputs[4:]))
    max_iters = 40 if inputs == "capped" else None
    packet = v6.v6_plain(*args[:2], *args[4:], args[2], args[3], max_iters, count=True)
    own = own_loops(*args, max_iters=max_iters)
    assert all(torch.equal(a, b) for a, b in zip(packet, own))
    iters = packet[6]
    assert iters.shape == (args[4].shape[0], 8)
    if inputs == "capped":
        assert int(iters.max()) == 40 and int((iters < 40).sum()) > 0
    elif inputs == "script":
        # The chains end unevenly: a packet's loop would run each packet to
        # its longest chain, 1.81x the chains' iterations here.
        assert int(iters.max(1).values.sum()) * 8 == 4816 and int(iters.sum()) == 2656


def test_v6_stack_cap_12_matches_script_and_fires_the_guard(monkeypatch, ref_inputs):
    """At stack_cap 12 (the smallest the kernel takes) the stall guard and
    the clamps change the walk: on the small tree's rays of seed 4 the
    chains run 2 iterations fewer than at the tree's own bound, and the
    plain version equals the script's traverse_v6 in interpret mode there;
    on the script's 8 packets the outputs change too."""
    mod = load_script(monkeypatch, "kernel_v6_probe.py", [])
    node, tri, nb, cap, o, d, tlim = small_inputs(seed=4)
    want = mod.traverse_v6(jnp.asarray(node.numpy()), jnp.asarray(tri.numpy()),
                           jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                           jnp.asarray(tlim.numpy()), stack_cap=12, n_brute_rows=nb,
                           interpret=True)
    *got, it12 = v6.v6(node, tri, o, d, tlim, nb, 12, count=True)
    for g, w in zip(got, want):
        agree(g.numpy(), np.asarray(w))
    *_, it_own = v6.v6_plain(node, tri, o, d, tlim, nb, cap, count=True)
    assert int(it_own.sum()) - int(it12.sum()) == 2
    node, tri, nb, cap, o, d, tlim = ref_inputs
    *big, it_big = v6.v6_plain(node, tri, o, d, tlim, nb, cap, count=True)
    *small, it_small = v6.v6_plain(node, tri, o, d, tlim, nb, 12, count=True)
    assert (int(it_big.sum()), int(it_small.sum())) == (2656, 2654)
    assert not torch.equal(big[0], small[0])


# (packets, SMs): the W v6 takes, at the sizes phase 13 of chip_smoke.py
# times on an H100 (7.8, 16, 32 and 64 chains an SM)
V6_W = {(128, H100_SMS): 4, (264, H100_SMS): 4, (528, H100_SMS): 2, (1056, H100_SMS): 2}


@pytest.mark.parametrize("packets, sms", list(V6_W))
def test_v6_picks_w(packets, sms):
    """The chain width v6 takes for the packets on a card of `sms` SMs, at
    the sizes where both widths were timed: W = 4 up to 16 chains an SM
    (the script's 128 packets on an H100), W = 2 from 32 (1,056 packets,
    the full card)."""
    got = v6.chosen_w(packets, sms)
    assert got == V6_W[(packets, sms)] and got in v6.ADMITTED_W


@pytest.mark.parametrize("w", [0, 1, 3, 8, -1])
def test_v6_unadmitted_w_raises(ref_inputs, w):
    """A W no kernel is built for raises before anything runs, on the CPU
    as on the card, in the wrapper, the entry point's run and the
    resources query."""
    node, tri, nb, cap, o, d, tlim = ref_inputs
    with pytest.raises(ValueError, match="chain width"):
        v6.v6(node, tri, o[:1], d[:1], tlim[:1], nb, cap, w=w)
    with pytest.raises(ValueError, match="chain width"):
        v6.kernel_resources(w)
    with pytest.raises(ValueError, match="chain width"):
        v6.run(1, "cpu", w=w)


def test_v6_plain_takes_any_admitted_w(ref_inputs):
    """On the CPU the wrapper runs the plain version, whose result no W
    changes."""
    node, tri, nb, cap, o, d, tlim = ref_inputs
    args = (node, tri, o[:2], d[:2], tlim[:2], nb, cap)
    ref = v6.v6_plain(*args, 20, count=True)
    for w in (None, *v6.ADMITTED_W):
        got = v6.v6(*args, 20, count=True, w=w)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert v6.ADMITTED_W == (2, 4)


def test_ktf_wrapper_takes_cpu_inputs_to_the_plain_version():
    """CPU inputs reach ktf_plain: the outputs per case, their count, dtype
    and [8, 128] shape, one plain call each and no launch; the fast path's
    signature and key words."""
    for case in ktf_probe.CASES:
        ins = tuple(torch.from_numpy(x) for x in ktf_probe.inputs(case))
        calls, launches = ktf_probe.PLAIN_CALLS["probe_ktf"], ktf_probe.LAUNCHES["probe_ktf"]
        got = ktf_probe.probe_ktf(case, *ins)
        assert ktf_probe.PLAIN_CALLS["probe_ktf"] == calls + 1
        assert ktf_probe.LAUNCHES["probe_ktf"] == launches
        want = ktf_probe.ktf_plain(case, *ins)
        assert len(got) == len(want) == ktf_probe.N_OUT[case]
        dtype = torch.int32 if case in ktf_probe.INT_OUT else torch.float32
        assert all(g.dtype == dtype and tuple(g.shape) == ktf_probe.TILE and torch.equal(g, w)
                   for g, w in zip(got, want))
        assert all(cudalib.signature(t) != ktf_probe._IN for t in ins)
    k0, k1 = ktf.key_words(ktf_probe.KEY)
    assert ktf_probe._KEYS["threefry"] == (ktf_probe.K0 & 0xFFFFFFFF, ktf_probe.K1)
    assert ktf_probe._KEYS["sampler_tile"] == (k0 & 0xFFFFFFFF, k1 & 0xFFFFFFFF)


KTF_DEFECTS = {  # defect: (the first input made wrong, the error it raises)
    "device": (lambda t: t.to("meta"), "unsupported device meta"),
    "dtype": (lambda t: t.long(), "expected torch.int32, got torch.int64"),
    "shape": (lambda t: t[:, :64].contiguous(), "expected shape"),
    "contiguity": (lambda t: t.t().contiguous().t(), "expected a contiguous tensor"),
}


@pytest.mark.parametrize("defect", KTF_DEFECTS)
@pytest.mark.parametrize("case", ["threefry", "sampler_tile"])
def test_ktf_wrapper_guards(case, defect):
    """The wrapper's guards (the same on the CPU and the card) raise on an
    input on the wrong device or of the wrong dtype, shape or contiguity,
    and on the wrong number of inputs; the script's inputs pass them and
    take the plain version here."""
    ins = [torch.from_numpy(x) for x in ktf_probe.inputs(case)]
    assert ktf_probe._takes(case, tuple(ins)) is False
    spoil, match = KTF_DEFECTS[defect]
    with pytest.raises(ValueError, match=match):
        ktf_probe.probe_ktf(case, spoil(ins[0]), *ins[1:])
    with pytest.raises(ValueError, match="takes"):
        ktf_probe.probe_ktf(case, *ins, ins[0])
    with pytest.raises(ValueError, match="unknown case"):
        ktf_probe.probe_ktf("disk", *ins)
