"""Dual-unit traversal on the card: the port of scripts/kernel_v6_probe.py
(`_make_kernel_v6` :94, TPU call :358; its main() :375).

In each iteration a chain of 128 rays runs two units: a leaf unit sweeps
one triangle row from a leaf-row stack while an internal unit expands one
node of a 4-wide tree from a node stack, on the row-per-node v6 tables
(probes/v6_tables.py). Kernel: csrc/probe_v6.cu (a chain of W = 2 or 4
warps in a block of its own, looping to its own end; `chosen_w` picks W);
plain PyTorch version: `v6_plain`, which takes the same steps in the same
order, the chains as [P, 8] tensors and their lanes as [P, 8, 128]. Both
return, per ray, t (the limit where nothing is hit), the original face id
(-1), its material id (0) and the unnormalized normal (0): six
[P, 8, 128] arrays, and each chain's iteration count. No W changes the
plain version's result.

The entry point does what the script's main() does, on the reference
scene built 4-wide: 131,072 seeded rays (`v5_body.make_rays`, tlim BIG),
v6 held against `trace_closest` (K4 on the same tree, sort=False) by the
script's rule — t within rtol 1e-5, ids, materials and hits equal — and
the two timed in turns (CUDA events, median of 10); `--w W` takes that
chain width instead of the picked one.

    python -m raytracer_tpu_torch.probes.v6 [n_packets] [--w W] [--device cpu]
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from raytracer_tpu_torch.probes import common, v5_body
from raytracer_tpu_torch.probes.common import MT_OPS, SLAB_OPS, big_like, f2i
from raytracer_tpu_torch.probes.v5_tables import BIG, HALF_BIG, NONE, P_LANE, P_SUB
from raytracer_tpu_torch.probes.v6_tables import pack_tables_v6
from raytracer_tpu_torch.utils import cudalib

N_PACKETS = 128
IDLE = -1            # leaf unit idle: it sweeps the zero row
T_RTOL = 1e-5        # the script's rule against K4 (:430)
# The chain widths csrc/probe_v6.cu is built at (its `kernel_of`), and the
# chains per SM up to which `chosen_w` takes the widest.
ADMITTED_W = (2, 4)
W4_CHAINS_PER_SM = 16
LAUNCHES = {"probe_v6": 0}
PLAIN_CALLS = {"probe_v6": 0}


def default_max_iters(node, tri, n_brute_rows: int) -> int:
    """The script's loop bound (:357): node rows + leaf rows + 8."""
    return node.shape[0] + (tri.shape[0] - 1 - n_brute_rows) + 8


def v6_plain(node, tri, o, d, tlim, n_brute_rows: int, stack_cap: int, max_iters=None,
             count: bool = False):
    """Plain version: (t, id, mat, nx, ny, nz), each [P, 8, 128], and with
    `count` also i32[P, 8], the iterations each chain ran (the loop runs
    while any chain has work; a finished chain's iterations change nothing
    and are not counted, so each chain's count is that of its own loop)."""
    PLAIN_CALLS["probe_v6"] += 1
    if max_iters is None:
        max_iters = default_max_iters(node, tri, n_brute_rows)
    dev, P = o.device, o.shape[0]
    zero_row = tri.shape[0] - 1
    ov, dv, iv = common.rays(o, d)
    i32 = dict(dtype=torch.int32, device=dev)
    lanes = torch.zeros((P, P_SUB, P_LANE), dtype=torch.float32, device=dev)
    state = (tlim.clone(), torch.full((P, P_SUB, P_LANE), int(NONE), **i32),
             torch.zeros((P, P_SUB, P_LANE), **i32), lanes, lanes.clone(), lanes.clone())

    # Brute pre-pass: the rows before the zero row.
    for r in range(zero_row - n_brute_rows, zero_row):
        state = common.mt_row8(tri[r], ov, dv, state)

    # Root test: the union of the root's child boxes (:196-214).
    rhit = common.root_hit(node, ov, iv, state[0])
    zero = torch.zeros((P, P_SUB), **i32)
    none = torch.full_like(zero, int(NONE))
    ntask = torch.where(rhit.sum(2) > 0, zero, none)
    ltask = torch.full_like(zero, IDLE)
    sp, lsp = zero.clone(), zero.clone()
    stack = torch.zeros((P, P_SUB, stack_cap), **i32)
    lstack = torch.zeros((P, P_SUB, stack_cap), **i32)
    iters = zero.clone()
    alive = ntask != NONE
    zrow = torch.full_like(zero, zero_row)

    it = 0
    while it < max_iters and bool(alive.any()):
        iters += alive.to(torch.int32)
        nrow = node[torch.where(ntask >= 0, ntask, zero).long()]          # [P, 8, 128]
        trow = tri[torch.where(ltask >= 0, ltask, zrow).long()]
        ch = f2i(nrow[..., 24:28])

        # Leaf unit, then the internal unit against the updated t_best.
        state = common.mt_row8(trow, ov, dv, state)
        hks, reps = [], []
        for k in range(4):
            hk, tk = common.slab(tuple(nrow[..., k * 6 + j, None] for j in range(6)), ov, iv,
                                 state[0])
            hks.append(hk)
            reps.append(torch.where(hk, tk, torch.full_like(tk, float(HALF_BIG)))[..., 0])
        pa = (hks[0].to(torch.int32) + (hks[1].to(torch.int32) << 16)).sum(2, dtype=torch.int32)
        pb = (hks[2].to(torch.int32) + (hks[3].to(torch.int32) << 16)).sum(2, dtype=torch.int32)
        anyk = [(pa & 0xFFFF) > 0, (pa >> 16) > 0, (pb & 0xFFFF) > 0, (pb >> 16) > 0]
        codes = [ch[..., k] for k in range(4)]
        valid = [anyk[k] & (codes[k] != NONE) for k in range(4)]
        leaf = [c <= -2 for c in codes]
        ki, ci = common.sort4([torch.where(valid[k] & ~leaf[k], reps[k], big_like(reps[k]))
                         for k in range(4)], codes)
        kl, cl = common.sort4([torch.where(valid[k] & leaf[k], reps[k], big_like(reps[k]))
                         for k in range(4)], codes)
        n_int = sum((x < float(BIG)).to(torch.int32) for x in ki)
        n_leaf = sum((x < float(BIG)).to(torch.int32) for x in kl)

        # Scalar phase (:295-335).
        stall = lsp >= stack_cap - 8
        go = (ntask >= 0) & ~stall
        nh_i = torch.where(go, n_int, zero)
        nh_l = torch.where(go, n_leaf, zero)
        for k in (3, 2, 1):
            stack.scatter_(2, (sp + (nh_i - 1 - k).clamp_min(0)).long()[..., None],
                           ci[k][..., None])
        new_sp = (sp + (nh_i - 1).clamp_min(0)).clamp_max(stack_cap - 4)
        desc = torch.where(nh_i > 0, ci[0], none)
        do_pop = ~stall & (desc == NONE) & (new_sp > 0) & (ntask != NONE)
        popped = torch.gather(stack, 2, (new_sp - 1).clamp_min(0).long()[..., None])[..., 0]
        nxt = torch.where(stall, ntask, torch.where(do_pop, popped, desc))
        sp = torch.where(do_pop, new_sp - 1, new_sp)
        for k in (3, 2, 1):
            lstack.scatter_(2, (lsp + (nh_l - 1 - k).clamp_min(0)).long()[..., None],
                            (-cl[k] - 2)[..., None])
        new_lsp = (lsp + (nh_l - 1).clamp_min(0)).clamp_max(stack_cap - 4)
        lt_new = torch.where(nh_l > 0, -cl[0] - 2, torch.full_like(zero, IDLE))
        l_pop = (lt_new == IDLE) & (new_lsp > 0)
        l_popped = torch.gather(lstack, 2, (new_lsp - 1).clamp_min(0).long()[..., None])[..., 0]
        ltask = torch.where(l_pop, l_popped, lt_new)
        lsp = torch.where(l_pop, new_lsp - 1, new_lsp)
        ntask = nxt
        alive = (ntask != NONE) | (ltask != IDLE)
        it += 1
    return (*state, iters) if count else state


def _check(node, tri, o, d, tlim, n_brute_rows: int, stack_cap: int, max_iters: int):
    P = o.shape[0]
    for name, t in (("node", node), ("tri", tri)):
        cudalib.require_cuda(name, t, torch.float32)
        if t.dim() != 2 or t.shape[1] != 128:
            raise ValueError(f"v6: {name} must be f32[rows, 128]")
    cudalib.require_cuda("o", o, torch.float32, (P, 3, P_SUB, P_LANE))
    cudalib.require_cuda("d", d, torch.float32, (P, 3, P_SUB, P_LANE))
    cudalib.require_cuda("tlim", tlim, torch.float32, (P, P_SUB, P_LANE))
    if not 0 <= n_brute_rows < tri.shape[0]:
        raise ValueError(f"v6: {n_brute_rows} brute rows in a table of {tri.shape[0]}")
    if not 12 <= stack_cap <= 4096:
        raise ValueError(f"v6: stack_cap {stack_cap} outside [12, 4096]")
    if max_iters < 0:
        raise ValueError("v6: max_iters must be >= 0")
    cudalib.require_aligned("node", node.data_ptr())   # rows read 16 bytes at a time
    cudalib.require_aligned("tri", tri.data_ptr())


def v6(node, tri, o, d, tlim, n_brute_rows: int, stack_cap: int, max_iters=None,
       count: bool = False, w: int | None = None):
    """(t, id, mat, nx, ny, nz) of the dual-unit traversal, [P, 8, 128]
    each (with `count`, also the chains' iterations i32[P, 8]): launches
    csrc/probe_v6.cu for CUDA tensors at chain width w (one of ADMITTED_W;
    None: `chosen_w` on the tensors' card), runs the plain version for CPU
    tensors, whose result no W changes. max_iters None is the script's
    bound."""
    if w is not None:
        common.require_w(w, ADMITTED_W, "v6")
    if not o.is_cuda:
        if o.device.type != "cpu":
            raise ValueError(f"v6: unsupported device {o.device}")
        return v6_plain(node, tri, o, d, tlim, n_brute_rows, stack_cap, max_iters, count)
    if max_iters is None:
        max_iters = default_max_iters(node, tri, n_brute_rows)
    _check(node, tri, o, d, tlim, n_brute_rows, stack_cap, max_iters)
    P, dev = o.shape[0], o.device
    if w is None:
        w = chosen_w(P, common.sm_count(dev))
    f32 = [torch.empty((P, P_SUB, P_LANE), dtype=torch.float32, device=dev) for _ in range(4)]
    i32 = [torch.empty((P, P_SUB, P_LANE), dtype=torch.int32, device=dev) for _ in range(2)]
    iters = torch.empty((P, P_SUB), dtype=torch.int32, device=dev)
    t, nx, ny, nz = f32
    ids, mat = i32
    code = cudalib.lib().rt_probe_v6_w(
        node.data_ptr(), tri.data_ptr(), o.data_ptr(), d.data_ptr(), tlim.data_ptr(),
        tri.shape[0] - 1, n_brute_rows, stack_cap, max_iters, P, w, t.data_ptr(), ids.data_ptr(),
        mat.data_ptr(), nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), iters.data_ptr(),
        cudalib.stream_handle())
    cudalib.check(code, f"probe_v6 kernel (W {w})")
    LAUNCHES["probe_v6"] += 1
    out = (t, ids, mat, nx, ny, nz)
    return (*out, iters) if count else out


def chosen_w(packets: int, sms: int | None = None) -> int:
    """The chain width `v6` takes for `packets` packets on a card of `sms`
    SMs (the current card's by default): W = 4 while the card has at most
    W4_CHAINS_PER_SM chains an SM, else W = 2. On an NVIDIA H100 80GB HBM3
    (132 SMs, 700 W; chip_smoke.py phase 13 times both widths at 128 and
    1,056 packets and in turns at 264 and 528), in one run: at 7.8 chains
    an SM W = 4 took 0.554 ms against 0.619 at W = 2, at 16 0.853 against
    0.866, at 32 1.512 against 1.450, at 64 2.844 against 2.624. So the
    widths cross between 16 and 32 chains an SM; no size in between was
    timed. Few chains leave the schedulers idle between an iteration's
    dependent steps, and four warps a chain fill them; many chains fill
    them anyway, and W = 2 repeats the chain-uniform work (the rows, the
    sums, the decisions) in half as many warps."""
    sms = common.sm_count() if sms is None else sms
    return 4 if packets * P_SUB <= W4_CHAINS_PER_SM * sms else 2


def kernel_resources(w: int) -> tuple[int, int]:
    """(registers per thread, local memory bytes per thread) of the kernel of
    chain width w."""
    common.require_w(w, ADMITTED_W, "v6")
    regs, local = ctypes.c_int(), ctypes.c_int()
    cudalib.check(cudalib.lib().rt_probe_v6_attrs_w(w, ctypes.byref(regs), ctypes.byref(local)),
                  f"probe_v6 attributes (W {w})")
    return regs.value, local.value


def work(node, tri, o, chain_iters: int, n_brute_rows: int) -> dict:
    """Bytes (tables and rays read once, tlim in, the six outputs out) and
    fp32 operations (common.MT_OPS, SLAB_OPS) of a run whose chains took
    `chain_iters` iterations in all: per chain iteration 8 MT records and
    4 slabs for each of its 128 lanes, plus the brute pre-pass and the
    root slab of every ray."""
    n_rays = o.shape[0] * P_SUB * P_LANE
    per_iter = (8 * MT_OPS + 4 * SLAB_OPS) * P_LANE
    ops = chain_iters * per_iter + n_rays * (8 * n_brute_rows * MT_OPS + SLAB_OPS)
    return dict(bytes=4 * (node.numel() + tri.numel() + 2 * o.numel() + 7 * n_rays), ops=ops)


def reference_inputs(packets: int = N_PACKETS):
    """The script's inputs on the reference scene built 4-wide: (the
    scene's Bvh4, node, tri, n_brute_rows, stack_cap, o, d, tlim) on the
    CPU; o, d, tlim packed [P, 3, 8, 128] / [P, 8, 128]."""
    from raytracer_tpu_torch.scene.builder import reference_scene, tree_width

    with tree_width(4):
        bvh = reference_scene().bvh4
    node, tri, _, n_brute = pack_tables_v6(bvh, bvh.face_mat)
    o, d, tlim = (torch.from_numpy(a) for a in v5_body.make_rays(packets, seed=0))
    return bvh, node, tri, n_brute, bvh.stack_depth + 4, o, d, tlim


def unpack(x: torch.Tensor) -> torch.Tensor:
    """[P, 3, 8, 128] packed rays → [P * 1024, 3], ray p * 1024 + s * 128 + l."""
    return x.reshape(x.shape[0], 3, P_SUB * P_LANE).transpose(1, 2).reshape(-1, 3).contiguous()


def against_k4(out, ref) -> dict:
    """The script's rule (:422-435): v6's (t, id, mat) against K4's record
    `ref` (trace_closest): mismatch counts of t (rtol 1e-5), ids, materials
    and hits, the rays and the hits."""
    t, ids, mat = (x.reshape(-1) for x in out[:3])
    found = ids >= 0
    t_cmp = torch.where(found, t, torch.full_like(t, float(BIG)))
    id_cmp = torch.where(found, ids, torch.zeros_like(ids))
    mat_cmp = torch.where(found, mat, torch.zeros_like(mat))
    t_ok = np.isclose(t_cmp.cpu().numpy(), ref["t"].cpu().numpy(), rtol=T_RTOL)
    return dict(t=int((~t_ok).sum()), tri=int((id_cmp != ref["tri_id"]).sum()),
                mat=int((mat_cmp != ref["mat_id"]).sum()),
                hit=int((found != ref["hit"]).sum()), n=int(t.numel()),
                hits=int(found.sum()))


def run(packets: int = N_PACKETS, device="cuda", inputs=None, out=print,
        w: int | None = None) -> dict:
    """What the script's main() does: v6 and K4 on the reference scene's
    4-wide tree, the mismatch counts and, on the card, the two timed in
    alternating turns (CUDA events, median of 10 each), v6 at chain width
    w (None: the one `v6` picks)."""
    from raytracer_tpu_torch.ops.cuda_traverse import trace_closest

    device = torch.device(device)
    if device.type == "cuda":
        common.require_card("v6")
    if w is not None:
        common.require_w(w, ADMITTED_W, "v6")
    bvh, node, tri, n_brute, cap, o, d, tlim = inputs or reference_inputs(packets)
    bvh = bvh.to(device)
    node, tri, o, d, tlim = (t.to(device).contiguous() for t in (node, tri, o, d, tlim))
    o_flat, d_flat = unpack(o), unpack(d)
    ref = trace_closest(o_flat, d_flat, bvh, float(BIG), sort=False)
    res = v6(node, tri, o, d, tlim, n_brute, cap, count=True, w=w)
    mis = against_k4(res[:6], ref)
    r = dict(packets=o.shape[0], mismatches=mis, chain_iters=int(res[6].sum()),
             longest_chain=int(res[6].max()), max_iters=default_max_iters(node, tri, n_brute),
             stack_cap=cap)
    out(f"mismatches: t={mis['t']} tri={mis['tri']} mat={mis['mat']} hit={mis['hit']} "
        f"(n={mis['n']}, hits={mis['hits']}); chain iterations {r['chain_iters']} (the "
        f"longest chain {r['longest_chain']}, bound {r['max_iters']})")
    if o.is_cuda:
        w = chosen_w(o.shape[0]) if w is None else w
        fns = {"v5": lambda: trace_closest(o_flat, d_flat, bvh, float(BIG), sort=False),
               "v6": lambda: v6(node, tri, o, d, tlim, n_brute, cap, w=w)}
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        times = {k: [] for k in fns}
        for turn in range(common.TIMED_LAUNCHES):
            for k in (fns if turn % 2 == 0 else list(fns)[::-1]):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fns[k]()
                b.record()
                torch.cuda.synchronize()
                times[k].append(a.elapsed_time(b))
        ms = {k: common.median(v) for k, v in times.items()}
        regs, local = kernel_resources(w)
        r.update(ms=ms["v6"], ms_k4=ms["v5"], times_ms=times, w=w, num_regs=regs,
                 local_bytes=local)
        p = o.shape[0]
        out(f"v5: {ms['v5']:8.4f} ms  ({ms['v5'] / p * 1e3:7.2f} us/packet)   (K4, 4-wide tree)")
        out(f"v6: {ms['v6']:8.4f} ms  ({ms['v6'] / p * 1e3:7.2f} us/packet)  speedup "
            f"x{ms['v5'] / ms['v6']:.2f}   W {w}  regs {regs} local {local} B")
    return r


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = common.device_arg(argv, "v6")
    w = None
    if "--w" in argv:
        i = argv.index("--w")
        w = int(argv[i + 1])
        del argv[i:i + 2]
    packets = int(argv[0]) if argv else N_PACKETS
    run(packets, device, w=w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
