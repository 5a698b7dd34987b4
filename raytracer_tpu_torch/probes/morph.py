"""The v5 traversal body morphed toward K4 one structural delta at a time,
on the card: the port of scripts/kernel_morph.py (run_variant :52, TPU call
:324; VARIANTS :27-49). Kernel: csrc/probe_morph.cuh (one instantiation
per variant and chain width W, in probe_morph.cu and probe_morph_part2-4.cu);
plain PyTorch version: `morph_plain`, which takes the same steps in the
same order, the chains as [P, 8] tensors and their lanes as [P, 8, 128].

A variant is (loop, outs, init, brute, clamp):
  loop   fori: ITERS iterations, a chain whose walk ends restarts at the
         root; while: while the packet's alive count (chains whose next task
         is not NONE) is > 0, a finished chain staying at NONE;
         whilecounter: fori's loop as a counted while; whilealivecap: while
         counter > 0 and alive > 0, restarting as fori does
  outs   1 (t) or 6 (t, prim id, material id, the unnormalised normal)
  init   "all" chains start at the root, or "root": only a chain with a lane
         that hits the union of the root's child boxes (NONE otherwise)
  brute  the brute-force rows swept before the walk
  clamp  stack pushes with the pointer clamped to stack_cap - 4, or not

The stack capacity is the tree's bound, `stack_depth` (32 on the
reference scene's 4-wide tree); the stack is one flat array of
8 * stack_cap entries per packet, chain s at s * stack_cap, as in the
script. Both versions also return each packet's loop count i32[P]; a
`while` loop stops at `max_iters` (a guard for the card, far above any
walk), and the entry point checks it was not reached.

On the card a chain is W warps (W = 1, 2 or 4, `chosen_w`). A finished
`while` chain changes nothing in the packet's loop, so there each chain
loops on its own and the packet's count is the largest of its chains'.

The entry point does what the script does without arguments: each
variant in a fresh process, "PASS <variant>: ok hit=<hits>/<rays>" per
variant, on the reference scene built 4-wide with 8 packets of 1,024 rays
(default_rng(3), tlim BIG); on the card each variant's line also carries
the median of 10 launches, ns per chain-iteration, the chain width,
registers and local memory. With a variant named it runs that one in this
process.

    python -m raytracer_tpu_torch.probes.morph [variant] [--device cpu]
"""

from __future__ import annotations

import sys
from types import SimpleNamespace

import torch

from raytracer_tpu_torch.probes import common, v5_body
from raytracer_tpu_torch.probes.common import MT_OPS, SLAB_OPS, big_like, f2i
from raytracer_tpu_torch.probes.v5_tables import (HALF_BIG, NODE_STRIDE, NONE, P_LANE, P_SUB,
                                                  pack_tables, select_record)
from raytracer_tpu_torch.utils import cudalib

# name: (loop, outs, init, brute, clamp), the script's order (the kernel's
# instantiation ids in csrc/probe_morph*.cu).
VARIANTS = {
    "v0_ablate": ("fori", 1, "all", False, True),
    "v1_while": ("while", 1, "all", False, True),
    "v2_outs6": ("while", 6, "all", False, True),
    "v3_rootinit": ("while", 6, "root", False, True),
    "v4_brute": ("while", 6, "root", True, True),
    "v5_noclamp": ("while", 6, "root", True, False),
    "v0_noclamp": ("fori", 1, "all", False, False),
    "v6_whilecounter": ("whilecounter", 1, "all", False, True),
    "v7_whilealive_cap": ("whilealivecap", 1, "all", False, True),
    "v8_cap_outs6": ("whilealivecap", 6, "all", False, True),
    "v9_cap_rootinit": ("whilealivecap", 6, "root", False, True),
    "v10_cap_brute": ("whilealivecap", 6, "root", True, True),
    "v11_cap_noclamp": ("whilealivecap", 6, "root", True, False),
}
LOOPS = ("fori", "while", "whilecounter", "whilealivecap")   # csrc/probe_morph.cuh `Loop`
ITERS, N_PACKETS, SEED = 40, 8, 3
MAX_ITERS = 1 << 16
# The chain widths each variant's kernel is built at (csrc/probe_morph.cuh
# admits): 1, 2 and 4, but not 4 for the six-output whilealivecap variants,
# whose 1,024-thread packet block leaves 64 registers a thread.
ADMITTED_W = {name: common.CHAIN_WIDTHS if not (loop == "whilealivecap" and outs == 6)
              else (1, 2) for name, (loop, outs, *_) in VARIANTS.items()}
LAUNCHES = {"probe_morph": 0}
PLAIN_CALLS = {"probe_morph": 0}


def _variant(name: str) -> tuple:
    if name not in VARIANTS:
        raise ValueError(f"morph probe: unknown variant {name!r} ({', '.join(VARIANTS)})")
    return VARIANTS[name]


def variant_of(args) -> str:
    """The variant of a kernel's template arguments (loop, outs6, root,
    brute, clamp), as probes/sass.py reads them from its name."""
    loop, outs6, root, brute, clamp = args
    key = (LOOPS[loop], 6 if outs6 else 1, "root" if root else "all", bool(brute), bool(clamp))
    return next(name for name, v in VARIANTS.items() if v == key)


def reference_inputs(packets: int = N_PACKETS):
    """The script's inputs: the v5 tables of the reference scene built
    4-wide, its brute row count and stack bound, and `packets` x 1,024 rays
    of default_rng(3) (tlim BIG): (node, tri, n_brute_rows, stack_cap, o,
    d, tlim) on the CPU."""
    from raytracer_tpu_torch.scene.builder import reference_scene, tree_width

    with tree_width(4):
        bvh = reference_scene().bvh4
    return tables_inputs(bvh, packets)


def tables_inputs(bvh4, packets: int = N_PACKETS):
    """reference_inputs() for any 4-wide Bvh4."""
    node, tri, _, n_brute = pack_tables(bvh4, bvh4.face_mat)
    o, d, tlim = (torch.from_numpy(a) for a in v5_body.make_rays(packets, seed=SEED))
    return node, tri, n_brute, int(bvh4.stack_depth), o, d, tlim


def plain_start(node, tri, o, d, tlim, n_brute_rows: int, stack_cap: int, variant: str,
                iters: int = ITERS, max_iters: int = MAX_ITERS) -> SimpleNamespace:
    """The plain version's state before its loop: the lanes' records after
    the brute pre-pass, each chain's task, stack pointer and stack, and the
    per-chain counts of iterations run (`chain_it`) and of live ones
    (`live_it`, those begun at a task other than NONE), [P, 8] each."""
    loop, n_outs, init, brute, clamp = _variant(variant)
    PLAIN_CALLS["probe_morph"] += 1
    dev, P = o.device, o.shape[0]
    zero_row = tri.shape[0] - 1
    ov, dv, iv = common.rays(o, d)
    i32 = dict(dtype=torch.int32, device=dev)
    lanes = torch.zeros((P, P_SUB, P_LANE), dtype=torch.float32, device=dev)
    state = (tlim.clone(), torch.full((P, P_SUB, P_LANE), int(NONE), **i32),
             torch.zeros((P, P_SUB, P_LANE), **i32), lanes, lanes.clone(), lanes.clone())
    if brute:
        for r in range(zero_row - n_brute_rows, zero_row):
            state = common.mt_row8(tri[r], ov, dv, state)
    zero = torch.zeros((P, P_SUB), **i32)
    none = torch.full_like(zero, int(NONE))
    if init == "root":
        task = torch.where(common.root_hit(node, ov, iv, state[0]).sum(2) > 0, zero, none)
        n_alive = (task != NONE).sum(1, dtype=torch.int32)
    else:
        task = zero.clone()
        n_alive = torch.full((P,), P_SUB, **i32)
    return SimpleNamespace(
        node=node, tri=tri, ov=ov, dv=dv, iv=iv, variant=variant, loop=loop, n_outs=n_outs,
        clamp=clamp, stack_cap=stack_cap, max_iters=max_iters, zero=zero, none=none,
        zrow=torch.full_like(zero, zero_row),
        base=(torch.arange(P_SUB, device=dev, dtype=torch.int32) * stack_cap).expand(P, P_SUB),
        state=state, task=task, n_alive=n_alive, sp=zero.clone(),
        stack=torch.zeros((P, P_SUB * stack_cap), **i32), counter=torch.full((P,), iters, **i32),
        chain_it=zero.clone(), live_it=zero.clone())


def plain_running(c: SimpleNamespace) -> torch.Tensor:
    """Which chains run the packet loop's next iteration, [P, 8]: every
    chain of a packet whose loop goes on."""
    if c.loop in ("fori", "whilecounter"):
        pk = c.counter > 0
    elif c.loop == "while":
        pk = (c.n_alive > 0) & (c.chain_it.max(1).values < c.max_iters)
    else:
        pk = (c.counter > 0) & (c.n_alive > 0)
    return pk[:, None].expand_as(c.task)


def plain_step(c: SimpleNamespace, act: torch.Tensor) -> None:
    """One iteration of the chains in `act` [P, 8], in place on c; the
    others keep their state. A packet's alive count and counter move where
    any of its chains ran. Raises if a push would leave its chain's stack
    (the script's writes there land in another chain's stack, in chain
    order, which neither the concurrent warps of the kernel nor this
    vectorised version reproduce; at or beyond 8 * stack_cap the script
    leaves the array)."""
    task, sp, zero, none, cap = c.task, c.sp, c.zero, c.none, c.stack_cap
    is_int = task >= 0
    is_leaf = task <= -2
    nrow = c.node[torch.where(is_int, task // 4, zero).long()]
    nrec = select_record(nrow, torch.where(is_int, task % 4, zero), 4, NODE_STRIDE)
    trow = c.tri[torch.where(is_leaf, (-task - 2) // 64, c.zrow).long()]
    ch = f2i(nrec[..., 24:28])
    new_state = common.mt_row8(trow, c.ov, c.dv, c.state)
    hks, reps = [], []
    for k in range(4):
        hk, tk = common.slab(tuple(nrec[..., k * 6 + j, None] for j in range(6)), c.ov, c.iv,
                             new_state[0])
        hks.append(hk)
        reps.append(torch.where(hk, tk, torch.full_like(tk, float(HALF_BIG)))[..., 0])
    pa = (hks[0].to(torch.int32) + (hks[1].to(torch.int32) << 16)).sum(2, dtype=torch.int32)
    pb = (hks[2].to(torch.int32) + (hks[3].to(torch.int32) << 16)).sum(2, dtype=torch.int32)
    anyk = [(pa & 0xFFFF) > 0, (pa >> 16) > 0, (pb & 0xFFFF) > 0, (pb >> 16) > 0]
    anyk = [a & (ch[..., k] != NONE) for k, a in enumerate(anyk)]
    nhit = torch.where(is_int, sum(a.to(torch.int32) for a in anyk), zero)
    _, cc = common.sort4([torch.where(anyk[k], reps[k], big_like(reps[k])) for k in range(4)],
                         [ch[..., k] for k in range(4)])
    top = sp + (nhit - 2).clamp_min(0)          # the highest slot a push or pop touches
    if bool(((top >= cap) & act).any()):
        beyond = bool(((c.base + top >= P_SUB * cap) & act).any())
        raise ValueError(f"morph probe ({c.variant}): a push reaches slot {int(top.max())} of "
                         f"a chain's {cap}-entry stack"
                         + (f", beyond the array of {P_SUB * cap}" if beyond else ""))
    new_stack = c.stack.clone()
    for k in (3, 2, 1):
        pos = c.base + sp + (nhit - 1 - k).clamp_min(0)
        new_stack.scatter_(1, pos.long(), cc[k])
    nsp = sp + (nhit - 1).clamp_min(0)
    if c.clamp:
        nsp = nsp.clamp_max(cap - 4)
    desc = torch.where(nhit > 0, cc[0], none)
    do_pop = (desc == NONE) & (nsp > 0) & (task != NONE)
    popped = torch.gather(new_stack, 1, (c.base + (nsp - 1).clamp_min(0)).long())
    nxt = torch.where(do_pop, popped, desc)
    new_task = nxt if c.loop == "while" else torch.where(nxt == NONE, zero, nxt)
    act_pk = act.any(1)
    c.state = tuple(torch.where(act[..., None], n, s) for n, s in zip(new_state, c.state))
    c.live_it = c.live_it + (act & (task != NONE)).to(torch.int32)
    c.task = torch.where(act, new_task, task)
    c.sp = torch.where(act, torch.where(do_pop, nsp - 1, nsp), sp)
    c.stack = torch.where(act.repeat_interleave(cap, 1), new_stack, c.stack)
    c.n_alive = torch.where(act_pk, (nxt != NONE).sum(1, dtype=torch.int32), c.n_alive)
    c.counter = torch.where(act_pk, c.counter - 1, c.counter)
    c.chain_it = c.chain_it + act.to(torch.int32)


def plain_result(c: SimpleNamespace, live: bool = False) -> tuple:
    """(t[, id, mat, nx, ny, nz], iters[, live]) of the state c: the
    outputs, each packet's loop count (its chains' largest) and, with
    live, each chain's live iterations."""
    return ((*c.state[:c.n_outs], c.chain_it.max(1).values.to(torch.int32))
            + ((c.live_it,) if live else ()))


def morph_plain(node, tri, o, d, tlim, n_brute_rows: int, stack_cap: int, variant: str,
                iters: int = ITERS, max_iters: int = MAX_ITERS, live: bool = False) -> tuple:
    """Plain version: (t[, id, mat, nx, ny, nz], iters) — the outputs
    [P, 8, 128] of the variant and its packets' loop counts i32[P]. Each
    packet runs its own loop: a packet whose loop has ended keeps its
    state while the others go on. With live, also each chain's live
    iterations i32[P, 8] (those it began at a task other than NONE).
    Raises if a push would leave its chain's stack (plain_step)."""
    c = plain_start(node, tri, o, d, tlim, n_brute_rows, stack_cap, variant, iters, max_iters)
    act = plain_running(c)
    while bool(act.any()):
        plain_step(c, act)
        act = plain_running(c)
    return plain_result(c, live)


def _check(node, tri, o, d, tlim, n_brute_rows: int, stack_cap: int):
    P = o.shape[0]
    for name, t in (("node", node), ("tri", tri)):
        cudalib.require_cuda(name, t, torch.float32)
        if t.dim() != 2 or t.shape[1] != 128:
            raise ValueError(f"morph probe: {name} must be f32[rows, 128]")
    cudalib.require_cuda("o", o, torch.float32, (P, 3, P_SUB, P_LANE))
    cudalib.require_cuda("d", d, torch.float32, (P, 3, P_SUB, P_LANE))
    cudalib.require_cuda("tlim", tlim, torch.float32, (P, P_SUB, P_LANE))
    if not 0 <= n_brute_rows < tri.shape[0]:
        raise ValueError(f"morph probe: {n_brute_rows} brute rows in a table of {tri.shape[0]}")
    if not 4 <= stack_cap <= 4096:
        raise ValueError(f"morph probe: stack_cap {stack_cap} outside [4, 4096]")
    cudalib.require_aligned("node", node.data_ptr())   # rows read 16 bytes at a time
    cudalib.require_aligned("tri", tri.data_ptr())


def morph(node, tri, o, d, tlim, n_brute_rows: int, stack_cap: int, variant: str,
          iters: int = ITERS, max_iters: int = MAX_ITERS, w: int | None = None) -> tuple:
    """(t[, id, mat, nx, ny, nz], iters) of the variant: launches
    csrc/probe_morph.cuh's kernel for CUDA tensors, at chain width w (one
    of ADMITTED_W[variant]; None: `chosen_w` on the tensors' card), and
    runs the plain version for CPU tensors, whose result no W changes."""
    loop, n_outs, *_ = _variant(variant)
    if w is not None:
        common.require_w(w, ADMITTED_W[variant], f"morph probe ({variant})")
    if not o.is_cuda:
        if o.device.type != "cpu":
            raise ValueError(f"morph probe: unsupported device {o.device}")
        return morph_plain(node, tri, o, d, tlim, n_brute_rows, stack_cap, variant, iters,
                           max_iters)
    _check(node, tri, o, d, tlim, n_brute_rows, stack_cap)
    if iters < 0 or max_iters < 0:
        raise ValueError("morph probe: iters and max_iters must be >= 0")
    P, dev = o.shape[0], o.device
    if w is None:
        w = chosen_w(P, variant, common.sm_count(dev))
    f32 = [torch.empty((P, P_SUB, P_LANE), dtype=torch.float32, device=dev)
           for _ in range(1 if n_outs == 1 else 4)]
    i32 = [torch.empty((P, P_SUB, P_LANE), dtype=torch.int32, device=dev)
           for _ in range(0 if n_outs == 1 else 2)]
    pk_iters = torch.empty((P,), dtype=torch.int32, device=dev)
    t = f32[0]
    ids, mat = (i32 + [None, None])[:2]
    nx, ny, nz = (f32[1:] + [None] * 3)[:3]

    def ptr(x):
        return None if x is None else x.data_ptr()

    args = (node.data_ptr(), tri.data_ptr(), o.data_ptr(), d.data_ptr(), tlim.data_ptr(),
            tri.shape[0] - 1, n_brute_rows, stack_cap, iters, max_iters, P,
            list(VARIANTS).index(variant))
    outs_p = (t.data_ptr(), ptr(ids), ptr(mat), ptr(nx), ptr(ny), ptr(nz), pk_iters.data_ptr(),
              cudalib.stream_handle())
    code = cudalib.lib().rt_probe_morph_w(*args, w, *outs_p)
    cudalib.check(code, f"probe_morph kernel ({variant}, W {w})")
    LAUNCHES["probe_morph"] += 1
    outs = (t,) if n_outs == 1 else (t, ids, mat, nx, ny, nz)
    return (*outs, pk_iters)


def chosen_w(packets: int, variant: str, sms: int | None = None) -> int:
    """The chain width `morph` takes for `packets` packets of `variant` on
    a card of `sms` SMs (the current card's by default): a `while` variant
    the widest it admits at any size, the others the v5 body's rule
    (common.pick_w, v5_body.WARPS_PER_SM). The fastest W of each loop kind
    at 8 and at 1,056 packets on an H100 (chip_smoke.py phase 13 times
    every W): a `while` chain, alone in its block, at W = 4 at both; the
    loops that run every chain of a packet at W = 4 at 8 packets and, but
    for v0_noclamp, at W = 1 at 1,056."""
    if VARIANTS[variant][0] == "while":
        return max(ADMITTED_W[variant])
    return common.pick_w(packets, common.sm_count() if sms is None else sms,
                         ADMITTED_W[variant], v5_body.WARPS_PER_SM)


def kernel_resources(variants=tuple(VARIANTS), w: int = 1) -> dict:
    """{variant: (registers per thread, local memory bytes per thread)} of
    the kernels of chain width w."""
    for v in variants:
        common.require_w(w, ADMITTED_W[v], f"morph probe ({v})")
    fn = cudalib.lib().rt_probe_morph_attrs_w
    return common.kernel_attrs(lambda i, r, lb: fn(i, w, r, lb),
                               {v: list(VARIANTS).index(v) for v in variants}, "probe_morph")


def work(node, tri, o, variant: str, chain_iters: int, n_brute_rows: int) -> dict:
    """Bytes (tables and rays read once, tlim in, the outputs and loop counts
    out) and fp32 operations (common.MT_OPS, SLAB_OPS) of a run whose
    chains took `chain_iters` live iterations in all (morph_plain's
    live counts: those begun at a task, which is the work the function
    asks for): per live chain-iteration 8 MT records and 4 slabs for each
    of its 128 lanes, plus the brute pre-pass and the root slab of every
    ray where the variant has them."""
    _, n_outs, init, brute, _ = _variant(variant)
    n_rays = o.shape[0] * P_SUB * P_LANE
    ops = chain_iters * (8 * MT_OPS + 4 * SLAB_OPS) * P_LANE
    ops += n_rays * ((8 * n_brute_rows * MT_OPS if brute else 0)
                     + (SLAB_OPS if init == "root" else 0))
    nbytes = 4 * (node.numel() + tri.numel() + 2 * o.numel() + (1 + n_outs) * n_rays
                  + o.shape[0])
    return dict(bytes=nbytes, ops=ops)


def hits(t: torch.Tensor) -> int:
    """The script's hit count: t < 1e30."""
    return int((t < 1e30).sum())


def run_variant(name: str, device="cuda", inputs=None, out=print) -> dict:
    """One variant as the script's run_variant runs it, on `inputs`
    (reference_inputs() by default): its line "ok hit=<hits>/<rays>", on
    the card after a warm-up and 10 timed launches at the chain width the
    entry point picks (median ms, ns per chain-iteration from the packets'
    loop counts, W, registers and local bytes)."""
    node, tri, n_brute, cap, o, d, tlim = inputs or reference_inputs()
    node, tri, o, d, tlim = (x.to(device).contiguous() for x in (node, tri, o, d, tlim))
    res = {}

    def call():
        res["out"] = morph(node, tri, o, d, tlim, n_brute, cap, name)

    r = {}
    if o.is_cuda:
        r["ms"] = common.median(common.time_launches(call))
        r["w"] = chosen_w(o.shape[0], name)
        r["num_regs"], r["local_bytes"] = kernel_resources((name,), r["w"])[name]
    else:
        call()
    *outs, pk = res["out"]
    if int(pk.max()) >= MAX_ITERS:
        raise RuntimeError(f"morph probe ({name}): a packet's loop reached the guard "
                           f"{MAX_ITERS}")
    r.update(packets=o.shape[0], iters=pk.cpu().tolist(), chain_iters=P_SUB * int(pk.sum()),
             hit=hits(outs[0]), rays=outs[0].numel())
    line = f"ok hit={r['hit']}/{r['rays']}"
    if "ms" in r:
        r["ns_per_chain_iter"] = r["ms"] * 1e6 / max(r["chain_iters"], 1)
        line += (f"   {r['ms']:8.4f} ms  {r['ns_per_chain_iter']:8.3f} ns/chain-iter  (loop "
                 f"{min(r['iters'])}-{max(r['iters'])} iterations)  W {r['w']}  regs "
                 f"{r['num_regs']} local {r['local_bytes']} B")
    out(line)
    return r


def run(packets: int = N_PACKETS, device="cuda", inputs=None, out=print) -> dict:
    """Every variant in this process (chip_smoke.py): {variant: run_variant's
    result}, each line prefixed with the variant's name."""
    inputs = inputs or reference_inputs(packets)
    return {v: run_variant(v, device, inputs, out=lambda line, v=v: out(f"{v:18s}: {line}"))
            for v in VARIANTS}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = common.device_arg(argv, "morph")
    if argv:
        run_variant(argv[0], device)
        return 0
    res = common.in_subprocesses(__spec__.name, VARIANTS, device)
    return 0 if all(res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
