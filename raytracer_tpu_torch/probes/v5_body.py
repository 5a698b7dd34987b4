"""One fixed-iteration v5 traversal body with the knockouts of four probe
scripts as its modes (kernel: csrc/probe_v5.cu; plain PyTorch version:
`v5_plain`). Each packet's 8 chains walk a 4-wide tree in the v5 tables
(probes/v5_tables.py) from the root; a chain whose walk ends restarts at
the root, so every mode runs exactly `iters` iterations.

  scripts/kernel_ablate.py (probes/ablate.py):
    full         node + triangle row per chain, 8 MT records, 4 slabs,
                 the hit-mask sums, the push/pop phase
    no_leaf      without the 8 MT records
    no_internal  without the slabs and sums
    no_scalar    without push/pop (the task steps through 0..1000)
    no_fetch     rows from a static row instead of dynamic row loads
  scripts/kernel_load_probe.py (probes/load_probe.py):
    full16       as full: two row loads per chain
    loads8       one row per chain, reused as the triangle row
    loads0       no loads: both rows made from chain 0's t_best + task
  scripts/kernel_floor_probe.py (probes/floor_probe.py):
    empty        the loop alone (t_best + 1 per iteration)
    carry8       + the chain's task stepped in registers
    smem8        + the chain's task stepped through shared memory
    prod_smem    the full body, task and stack pointer in shared memory
    prod_carry   the full body, task and stack pointer in registers
  scripts/kernel_base_probe.py (probes/base_probe.py), no loads:
    base         both rows from the chain's own t_best + its own task
    noconcat     the chain's own t_best + chain 0's task
    noc_nosc     noconcat without push/pop (the task steps through 0..1000)
    minimal      the loop alone, the task stepped through shared memory
                 (smem8's body)

On the TPU a chain's task, stack pointer and stack live in SMEM, the
scalar core's memory; here a chain is W warps (W = 1, 2 or 4, picked from
the packets and the card's SMs) and they live in each warp's slice of
shared memory (written by its lane 0, read by all its lanes, with
__syncwarp between), except in carry8 and prod_carry, which keep task and
stack pointer in registers: the difference of the two is what the floor
probe measures on this card.
"""

from __future__ import annotations


import numpy as np
import torch

from raytracer_tpu_torch.probes import common
from raytracer_tpu_torch.probes.common import MT_OPS, SLAB_OPS, big_like, f2i
from raytracer_tpu_torch.probes.v5_tables import (BIG, HALF_BIG, NODE_STRIDE, NONE, P_LANE,
                                                  P_SUB, TRI_STRIDE, pack_tables, select_record)
from raytracer_tpu_torch.utils import cudalib

ITERS, N_PACKETS = 119, 128
STACK_CAP = 40
RESTART = 1000  # no_scalar / carry8 / smem8: the task steps 0, 1, ..., 1000, 0, ...
# Mode → id of its instantiation in csrc/probe_v5.cu (the same order).
MODES = ("full", "no_leaf", "no_internal", "no_scalar", "no_fetch", "full16", "loads8",
         "loads0", "empty", "carry8", "smem8", "prod_smem", "prod_carry", "base", "noconcat",
         "noc_nosc", "minimal")
# The chain widths each mode's kernel is built at (csrc/probe_v5.cuh admits).
ADMITTED_W = {mode: common.CHAIN_WIDTHS for mode in MODES}
# The entry point widens a chain while the card holds at most this many
# warps per SM (csrc/probe_v5.cu rt_probe_v5_pick_w): at the scripts' 128
# packets W = 2 beat W = 1 and W = 4 (full 0.668 against 0.957 and 0.713
# ms on an H100).
WARPS_PER_SM = 16
LAUNCHES = {"probe_v5": 0}
PLAIN_CALLS = {"probe_v5": 0}   # calls of the plain version


def flags(mode: str) -> dict:
    """What a mode keeps. loads: table rows loaded per chain (0: both rows
    made from a t_best row + a task, the row chain 0's where row0, the
    task chain 0's where task0)."""
    if mode not in MODES:
        raise ValueError(f"v5 body: unknown mode {mode!r}")
    no_loads = ("loads0", "base", "noconcat", "noc_nosc")
    return dict(fetch=mode != "no_fetch", leaf=mode != "no_leaf",
                internal=mode != "no_internal", scalar=mode not in ("no_scalar", "noc_nosc"),
                loads=8 if mode == "loads8" else 0 if mode in no_loads else 16,
                row0=mode == "loads0", task0=mode in ("noconcat", "noc_nosc"),
                loop_only=mode in ("empty", "carry8", "smem8", "minimal"))


def reference_tables():
    """(node, tri, zero_row) of the reference scene built 4-wide, as the
    scripts' main() packs them (pallas_traverse._pack_tables)."""
    from raytracer_tpu_torch.scene.builder import reference_scene, tree_width

    with tree_width(4):
        scene = reference_scene()
    node, tri, _, _ = pack_tables(scene.bvh4, scene.bvh4.face_mat)
    return node, tri, tri.shape[0] - 1


def make_rays(packets: int = N_PACKETS, seed: int = 0):
    """The scripts' rays: `packets` x 1024 from `seed`, o uniform in
    ±0.28, d a normalised normal draw, packed to f32[packets,3,8,128];
    tlim f32[packets,8,128] = BIG."""
    rng = np.random.default_rng(seed)
    n = packets * 1024
    o = rng.uniform(-0.28, 0.28, (n, 3)).astype(np.float32)
    dd = rng.normal(size=(n, 3)).astype(np.float32)
    d = dd / np.linalg.norm(dd, axis=1, keepdims=True)

    def pack(x):
        return np.ascontiguousarray(
            x.reshape(packets, 1024, 3).transpose(0, 2, 1).reshape(packets, 3, P_SUB, P_LANE))

    tlim = np.full((packets, P_SUB, P_LANE), BIG, np.float32)
    return pack(o), pack(d.astype(np.float32)), tlim


def v5_plain(node, tri, o, d, tlim, zero_row: int, mode: str, iters: int):
    """Plain version: t f32[P,8,128] after `iters` iterations of `mode`,
    lanes as [P, 8, 128] tensors, chain state as [P, 8] tensors."""
    f = flags(mode)
    PLAIN_CALLS["probe_v5"] += 1
    dev, P = o.device, o.shape[0]
    ov, dv, iv = common.rays(o, d)
    t_best = tlim.clone()
    if f["loop_only"]:
        # The task of carry8 / smem8 / minimal reaches no output.
        for _ in range(iters):
            t_best = t_best + 1.0
        return t_best
    i32 = dict(dtype=torch.int32, device=dev)
    best = torch.full((P, P_SUB, P_LANE), int(NONE), **i32)
    task = torch.zeros((P, P_SUB), **i32)
    sp = torch.zeros((P, P_SUB), **i32)
    stack = torch.zeros((P, P_SUB, STACK_CAP), **i32)
    zero = torch.zeros_like(task)
    none = torch.full_like(task, int(NONE))
    zrow = torch.full_like(task, zero_row)
    for _ in range(iters):
        is_int = task >= 0
        is_leaf = task <= -2
        code = -task - 2
        if f["loads"] == 0:
            row = t_best[:, 0:1] if f["row0"] else t_best
            tk = task[:, 0:1] if f["task0"] else task
            fake = row + tk.to(torch.float32)[..., None]
            nrec, trow = fake[..., 0:NODE_STRIDE], fake
        elif f["fetch"]:
            nrow = node[torch.where(is_int, task // 4, zero).long()]
            nrec = select_record(nrow, torch.where(is_int, task % 4, zero), 4, NODE_STRIDE)
            trow = nrow if f["loads"] == 8 else tri[torch.where(is_leaf, code // 64, zrow).long()]
        else:
            nrec = node[0, 0:NODE_STRIDE].expand(P, P_SUB, NODE_STRIDE)
            trow = tri[0].expand(P, P_SUB, 128)
        ch8 = f2i(nrec[..., 24:28])

        if f["leaf"]:
            for k in range(8):
                trec = trow[..., k * TRI_STRIDE:(k + 1) * TRI_STRIDE, None]
                ids = f2i(trec[..., 9:11, :])
                t_best, best = common.mt_record(tuple(trec[..., c, :] for c in range(9)),
                                                ids[..., 0, :], ov, dv, t_best, best)

        if f["internal"]:
            hks, reps = [], []
            for k in range(4):
                hk, tk = common.slab(tuple(nrec[..., k * 6 + j, None] for j in range(6)),
                                     ov, iv, t_best)
                hks.append(hk)
                reps.append(torch.where(hk, tk, torch.full_like(tk, float(HALF_BIG)))[..., 0])
            pa = (hks[0].to(torch.int32) + (hks[1].to(torch.int32) << 16)).sum(2, dtype=torch.int32)
            pb = (hks[2].to(torch.int32) + (hks[3].to(torch.int32) << 16)).sum(2, dtype=torch.int32)
        else:
            pa = pb = torch.zeros_like(task)
            reps = [torch.zeros((P, P_SUB), dtype=torch.float32, device=dev)] * 4

        if f["scalar"]:
            anyk = [(pa & 0xFFFF) > 0, (pa >> 16) > 0, (pb & 0xFFFF) > 0, (pb >> 16) > 0]
            anyk = [a & (ch8[..., k] != NONE) for k, a in enumerate(anyk)]
            nhit = sum(a.to(torch.int32) for a in anyk)
            nhit = torch.where(is_int, nhit, zero)
            tm = [torch.where(anyk[k], reps[k], big_like(reps[k])) for k in range(4)]
            cc = [ch8[..., k] for k in range(4)]
            for i, j in ((0, 2), (1, 3), (0, 1), (2, 3), (1, 2)):
                sw = tm[i] > tm[j]
                tm[i], tm[j] = torch.where(sw, tm[j], tm[i]), torch.where(sw, tm[i], tm[j])
                cc[i], cc[j] = torch.where(sw, cc[j], cc[i]), torch.where(sw, cc[i], cc[j])
            for k in (3, 2, 1):
                pos = sp + (nhit - 1 - k).clamp_min(0)
                stack.scatter_(2, pos.long()[..., None], cc[k][..., None])
            new_sp = (sp + (nhit - 1).clamp_min(0)).clamp_max(STACK_CAP - 4)
            desc = torch.where(nhit > 0, cc[0], none)
            do_pop = (desc == NONE) & (new_sp > 0) & (task != NONE)
            popped = torch.gather(stack, 2, (new_sp - 1).clamp_min(0).long()[..., None])[..., 0]
            nxt = torch.where(do_pop, popped, desc)
            task = torch.where(nxt == NONE, zero, nxt)
            sp = torch.where(do_pop, new_sp - 1, new_sp)
        else:
            task = torch.where(task >= RESTART, zero, task + 1)
    return t_best


def _check(node, tri, o, d, tlim, zero_row: int, mode: str):
    P = o.shape[0]
    for name, t in (("node", node), ("tri", tri)):
        cudalib.require_cuda(name, t, torch.float32)
        if t.dim() != 2 or t.shape[1] != 128:
            raise ValueError(f"v5 body: {name} must be f32[rows, 128]")
    cudalib.require_cuda("o", o, torch.float32, (P, 3, P_SUB, P_LANE))
    cudalib.require_cuda("d", d, torch.float32, (P, 3, P_SUB, P_LANE))
    cudalib.require_cuda("tlim", tlim, torch.float32, (P, P_SUB, P_LANE))
    if not 0 <= zero_row < tri.shape[0]:
        raise ValueError(f"v5 body: zero_row {zero_row} outside the triangle table")
    cudalib.require_aligned("node", node.data_ptr())   # rows read 16 bytes at a time
    cudalib.require_aligned("tri", tri.data_ptr())
    if mode == "no_scalar" and node.shape[0] <= RESTART // 4:
        raise ValueError(f"v5 body: no_scalar walks node rows 0..{RESTART // 4}; the table "
                         f"has {node.shape[0]}")


def v5(node, tri, o, d, tlim, zero_row: int, mode: str, iters: int = ITERS,
       w: int | None = None):
    """t f32[P,8,128] of the v5 probe body in `mode`: launches
    csrc/probe_v5.cu for CUDA tensors, at chain width w (one of
    ADMITTED_W[mode]; None: the one the entry point picks, `chosen_w`),
    and runs the plain version for CPU tensors, whose result no W
    changes."""
    m = MODES.index(mode)
    if w is not None:
        common.require_w(w, ADMITTED_W[mode], f"v5 body ({mode})")
    if not o.is_cuda:
        if o.device.type != "cpu":
            raise ValueError(f"v5 body: unsupported device {o.device}")
        return v5_plain(node, tri, o, d, tlim, zero_row, mode, iters)
    _check(node, tri, o, d, tlim, zero_row, mode)
    P = o.shape[0]
    out = torch.empty((P, P_SUB, P_LANE), dtype=torch.float32, device=o.device)
    args = (node.data_ptr(), tri.data_ptr(), o.data_ptr(), d.data_ptr(), tlim.data_ptr(),
            zero_row, iters, P, m)
    L = cudalib.lib()
    code = (L.rt_probe_v5(*args, out.data_ptr(), cudalib.stream_handle()) if w is None else
            L.rt_probe_v5_w(*args, w, out.data_ptr(), cudalib.stream_handle()))
    cudalib.check(code, f"probe_v5 kernel ({mode}, W {w or 'picked'})")
    LAUNCHES["probe_v5"] += 1
    return out


def chosen_w(packets: int, mode: str) -> int:
    """The chain width the entry point takes for `packets` packets of
    `mode` on the current card (common.pick_w on its SM count,
    WARPS_PER_SM)."""
    w = cudalib.lib().rt_probe_v5_pick_w(packets, MODES.index(mode))
    if w <= 0:
        cudalib.check(-w, "probe_v5 pick_w")
    return w


def kernel_resources(modes=MODES, w: int = 1) -> dict:
    """{mode: (registers per thread, local memory bytes per thread)} of
    the kernels of chain width w."""
    for mode in modes:
        common.require_w(w, ADMITTED_W[mode], f"v5 body ({mode})")
    fn = cudalib.lib().rt_probe_v5_attrs_w
    return common.kernel_attrs(lambda m, r, lb: fn(m, w, r, lb),
                               {mode: MODES.index(mode) for mode in modes}, "probe_v5")


def lane_ops(mode: str) -> int:
    """fp32 operations of one lane in one iteration (common.MT_OPS,
    SLAB_OPS): 8 MT records, 4 slab tests, the add making the row of the
    modes without loads, the loop-only modes' t_best + 1."""
    f = flags(mode)
    if f["loop_only"]:
        return 1
    ops = (8 * MT_OPS if f["leaf"] else 0) + (4 * SLAB_OPS if f["internal"] else 0)
    return ops + (1 if f["loads"] == 0 else 0)


def work(node, tri, o, mode: str, iters: int) -> dict:
    """Bytes (tables and rays read once, tlim and t once) and fp32
    operations of `iters` iterations on these inputs."""
    P = o.shape[0]
    f = flags(mode)
    tables = 0 if (f["loop_only"] or f["loads"] == 0) else node.numel() + tri.numel()
    rays = 0 if f["loop_only"] else 2 * o.numel()
    return dict(bytes=4 * (tables + rays + 2 * P * P_SUB * P_LANE),
                ops=lane_ops(mode) * P * P_SUB * P_LANE * iters)


def run(script: str, modes, iters: int = ITERS, inputs=None, out=print) -> dict:
    """What a v5 script's main() does, on the card: the reference scene's
    v5 tables, the seeded rays, then each mode warmed up and 10 launches
    timed with CUDA events; prints kernel ms (median), ns per
    chain-iteration and (against the first mode) the difference."""
    common.require_card(script)
    dev = torch.device("cuda")
    if inputs is None:
        node, tri, zero_row = reference_tables()
        o, d, tlim = (torch.from_numpy(a) for a in make_rays())
        inputs = (node, tri, o, d, tlim, zero_row)
    node, tri, o, d, tlim, zero_row = inputs
    node, tri, o, d, tlim = (t.to(dev).contiguous() for t in (node, tri, o, d, tlim))
    packets = o.shape[0]
    ws = {mode: chosen_w(packets, mode) for mode in modes}
    res = {mode: kernel_resources((mode,), ws[mode])[mode] for mode in modes}
    results = {}
    for mode in modes:
        ms = common.median(common.time_launches(
            lambda: v5(node, tri, o, d, tlim, zero_row, mode, iters)))
        ns = ms * 1e6 / (packets * P_SUB * iters)
        r = dict(ms=ms, ns_per_chain_iter=ns, num_regs=res[mode][0], local_bytes=res[mode][1],
                 w=ws[mode])
        line = f"{mode:12s}: {ms:8.4f} ms  {ns:8.3f} ns/chain-iter"
        if mode != modes[0]:
            r["phase_cost_ns"] = results[modes[0]]["ns_per_chain_iter"] - ns
            line += f"   {modes[0]} - {mode} {r['phase_cost_ns']:+8.3f} ns"
        out(line + f"   regs {res[mode][0]} local {res[mode][1]} B")
        results[mode] = r
    return dict(script=script, iters=iters, packets=packets, modes=results)


def main_of(script: str, modes, argv) -> int:
    iters = int(argv[0]) if len(argv) > 0 else ITERS
    run(script, modes, iters)
    return 0
