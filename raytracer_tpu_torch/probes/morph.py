"""The v5 traversal body morphed toward K4 one structural delta at a time,
on the card: the port of scripts/kernel_morph.py (run_variant :52, TPU call
:324; VARIANTS :27-49). Kernel: csrc/probe_morph.cuh (one instantiation
per variant, in probe_morph.cu and probe_morph_part2.cu); plain PyTorch
version: `morph_plain`, which takes the same steps in the same order, the
chains as [P, 8] tensors and their lanes as [P, 8, 128].

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

The entry point does what the script does without arguments: each
variant in a fresh process, "PASS <variant>: ok hit=<hits>/<rays>" per
variant, on the reference scene built 4-wide with 8 packets of 1,024 rays
(default_rng(3), tlim BIG); on the card each variant's line also carries
the median of 10 launches, ns per chain-iteration, registers and local
memory. With a variant named it runs that one in this process.

    python -m raytracer_tpu_torch.probes.morph [variant] [--device cpu]
"""

from __future__ import annotations

import sys

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


def morph_plain(node, tri, o, d, tlim, n_brute_rows: int, stack_cap: int, variant: str,
                iters: int = ITERS, max_iters: int = MAX_ITERS) -> tuple:
    """Plain version: (t[, id, mat, nx, ny, nz], iters) — the outputs
    [P, 8, 128] of the variant and its packets' loop counts i32[P]. Each
    packet runs its own loop: a packet whose loop has ended keeps its
    state while the others go on. Raises if a push would leave its chain's
    stack (the script's writes there land in another chain's stack, in
    chain order, which neither the concurrent warps of the kernel nor this
    vectorised version reproduce; at or beyond 8 * stack_cap the script
    leaves the array)."""
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
    sp = zero.clone()
    stack = torch.zeros((P, P_SUB * stack_cap), **i32)
    base = (torch.arange(P_SUB, device=dev, dtype=torch.int32) * stack_cap).expand(P, P_SUB)
    zrow = torch.full_like(zero, zero_row)
    counter = torch.full((P,), iters, **i32)
    pk_iters = torch.zeros((P,), **i32)

    def running():
        if loop in ("fori", "whilecounter"):
            return counter > 0
        if loop == "while":
            return (n_alive > 0) & (pk_iters < max_iters)
        return (counter > 0) & (n_alive > 0)

    act = running()
    while bool(act.any()):
        is_int = task >= 0
        is_leaf = task <= -2
        nrow = node[torch.where(is_int, task // 4, zero).long()]
        nrec = select_record(nrow, torch.where(is_int, task % 4, zero), 4, NODE_STRIDE)
        trow = tri[torch.where(is_leaf, (-task - 2) // 64, zrow).long()]
        ch = f2i(nrec[..., 24:28])
        new_state = common.mt_row8(trow, ov, dv, state)
        hks, reps = [], []
        for k in range(4):
            hk, tk = common.slab(tuple(nrec[..., k * 6 + j, None] for j in range(6)), ov, iv,
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
        a2 = act[:, None]
        if bool(((top >= stack_cap) & a2).any()):
            beyond = bool(((base + top >= P_SUB * stack_cap) & a2).any())
            raise ValueError(f"morph probe ({variant}): a push reaches slot {int(top.max())} of a "
                             f"chain's {stack_cap}-entry stack"
                             + (f", beyond the array of {P_SUB * stack_cap}" if beyond else ""))
        new_stack = stack.clone()
        for k in (3, 2, 1):
            pos = base + sp + (nhit - 1 - k).clamp_min(0)
            new_stack.scatter_(1, pos.long(), cc[k])
        nsp = sp + (nhit - 1).clamp_min(0)
        if clamp:
            nsp = nsp.clamp_max(stack_cap - 4)
        desc = torch.where(nhit > 0, cc[0], none)
        do_pop = (desc == NONE) & (nsp > 0) & (task != NONE)
        popped = torch.gather(new_stack, 1, (base + (nsp - 1).clamp_min(0)).long())
        nxt = torch.where(do_pop, popped, desc)
        new_task = nxt if loop == "while" else torch.where(nxt == NONE, zero, nxt)
        a3 = act[:, None, None]
        state = tuple(torch.where(a3, n, s) for n, s in zip(new_state, state))
        task = torch.where(a2, new_task, task)
        sp = torch.where(a2, torch.where(do_pop, nsp - 1, nsp), sp)
        stack = torch.where(a2, new_stack, stack)
        n_alive = torch.where(act, (nxt != NONE).sum(1, dtype=torch.int32), n_alive)
        counter = torch.where(act, counter - 1, counter)
        pk_iters = pk_iters + act.to(torch.int32)
        act = running()
    return (*state[:n_outs], pk_iters)


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


def morph(node, tri, o, d, tlim, n_brute_rows: int, stack_cap: int, variant: str,
          iters: int = ITERS, max_iters: int = MAX_ITERS) -> tuple:
    """(t[, id, mat, nx, ny, nz], iters) of the variant: launches
    csrc/probe_morph.cuh's kernel for CUDA tensors, runs the plain version
    for CPU tensors."""
    loop, n_outs, *_ = _variant(variant)
    if not o.is_cuda:
        if o.device.type != "cpu":
            raise ValueError(f"morph probe: unsupported device {o.device}")
        return morph_plain(node, tri, o, d, tlim, n_brute_rows, stack_cap, variant, iters,
                           max_iters)
    _check(node, tri, o, d, tlim, n_brute_rows, stack_cap)
    if iters < 0 or max_iters < 0:
        raise ValueError("morph probe: iters and max_iters must be >= 0")
    P, dev = o.shape[0], o.device
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

    code = cudalib.lib().rt_probe_morph(
        node.data_ptr(), tri.data_ptr(), o.data_ptr(), d.data_ptr(), tlim.data_ptr(),
        tri.shape[0] - 1, n_brute_rows, stack_cap, iters, max_iters, P,
        list(VARIANTS).index(variant), t.data_ptr(), ptr(ids), ptr(mat), ptr(nx), ptr(ny),
        ptr(nz), pk_iters.data_ptr(), cudalib.stream_handle())
    cudalib.check(code, f"probe_morph kernel ({variant})")
    LAUNCHES["probe_morph"] += 1
    outs = (t,) if n_outs == 1 else (t, ids, mat, nx, ny, nz)
    return (*outs, pk_iters)


def kernel_resources(variants=tuple(VARIANTS)) -> dict:
    """{variant: (registers per thread, local memory bytes per thread)}."""
    return common.kernel_attrs(cudalib.lib().rt_probe_morph_attrs,
                               {v: list(VARIANTS).index(v) for v in variants}, "probe_morph")


def work(node, tri, o, variant: str, chain_iters: int, n_brute_rows: int) -> dict:
    """Bytes (tables and rays read once, tlim in, the outputs and loop counts
    out) and fp32 operations (common.MT_OPS, SLAB_OPS) of a run whose
    chains took `chain_iters` iterations in all: per chain-iteration 8 MT
    records and 4 slabs for each of its 128 lanes, plus the brute
    pre-pass and the root slab of every ray where the variant has them."""
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
    the card after a warm-up and 10 timed launches (median ms, ns per
    chain-iteration from the packets' loop counts, registers and local
    bytes)."""
    node, tri, n_brute, cap, o, d, tlim = inputs or reference_inputs()
    node, tri, o, d, tlim = (x.to(device).contiguous() for x in (node, tri, o, d, tlim))
    res = {}

    def call():
        res["out"] = morph(node, tri, o, d, tlim, n_brute, cap, name)

    r = {}
    if o.is_cuda:
        r["ms"] = common.median(common.time_launches(call))
        r["num_regs"], r["local_bytes"] = kernel_resources((name,))[name]
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
                 f"{min(r['iters'])}-{max(r['iters'])} iterations)  regs {r['num_regs']} "
                 f"local {r['local_bytes']} B")
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
