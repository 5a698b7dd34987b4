"""Per-iteration phase ablation of the round-5 BVH8 traversal body on the
card: the port of scripts/kernel_ablate_v8.py (its `make_kernel` :49, TPU
call :360).

A fixed-iteration copy of the body runs on synthetic task streams, so that
every variant executes the same iterations, with one phase knocked out at
a time:

  full      everything
  no_fetch  node rows from a static row instead of one dynamic row load
            per chain
  no_leaf   the leaf block (a triangle row load + 8 MT records) removed
  no_slab   the 8 child slab tests replaced by constant masks and keys
  no_reduce the 8 per-child rep-key min-reductions and the 4 pack
            sum-reductions replaced by lane 0's values
  no_sort   the two kind-split sort-8 networks skipped
  no_scalar the per-chain push/pop phase skipped

A phase's cost is full − variant. Kernel: csrc/probe_v8.cu (a chain of W
warps, W = 1, 2 or 4 picked from the packets and the card's SMs, 8 / W
chains per block of 256 threads; each warp's copy of the stacks in shared
memory, the chain's state in registers); `ablate_v8_plain` is its plain
PyTorch version.

    python -m raytracer_tpu_torch.probes.ablate_v8 [iters] [packets]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from raytracer_tpu_torch.ops.bvh4 import SORT_PAIRS
from raytracer_tpu_torch.probes import common
from raytracer_tpu_torch.probes.common import MT_OPS, SLAB_OPS, big_like, f2i
from raytracer_tpu_torch.probes.v5_tables import BIG, NONE, P_LANE, P_SUB, TRI_STRIDE
from raytracer_tpu_torch.utils import cudalib

ITERS, N_PACKETS = 400, 64
K = 8
STACK_CAP = 68
EMPTY16 = 0xFFFF            # "no code" half-sentinel of a pair-packed entry
SPARE_NONE = -1             # both halves empty
SPARE_HIGH = -65536         # 0xFFFF0000: empty high half
N_NODES, N_TRIROWS = 3648, 13981
VARIANTS = ("full", "no_fetch", "no_leaf", "no_slab", "no_reduce", "no_sort", "no_scalar")
ADMITTED_W = common.CHAIN_WIDTHS   # every variant's kernel is built at each
# The entry point widens a chain while the card holds at most this many
# warps per SM (csrc/probe_v8.cu rt_probe_v8_pick_w): at the script's 64
# packets W = 2 beat W = 4 and W = 1 (1.94 against 2.08 and 3.09 ms on an
# H100): every warp repeats two sorts and both stacks' push/pop.
WARPS_PER_SM = 8
LAUNCHES = {"probe_v8": 0}
PLAIN_CALLS = {"probe_v8": 0}   # calls of the plain version


def make_inputs(packets: int = N_PACKETS):
    """The script's inputs (main() :341-351), drawn in its order: node
    f32[3648,128] with float-encoded child codes in lanes 48:56, tri
    f32[13981,128], o / d f32[packets,3,8,128] (|d| < 1e-3 → 1e-3), from
    seed 0."""
    rng = np.random.default_rng(0)
    node = rng.normal(size=(N_NODES, 128)).astype(np.float32)
    codes = rng.integers(0, N_NODES, size=(N_NODES, K)).astype(np.float32)
    codes[rng.random((N_NODES, K)) < 0.4] *= -1
    node[:, 6 * K:7 * K] = codes
    tri = rng.normal(size=(N_TRIROWS, 128)).astype(np.float32)
    o = rng.normal(size=(packets, 3, P_SUB, P_LANE)).astype(np.float32)
    d = rng.normal(size=(packets, 3, P_SUB, P_LANE)).astype(np.float32)
    d = np.where(np.abs(d) < 1e-3, 1e-3, d).astype(np.float32)
    return node, tri, o, d


def _scatter(stack, pos, val):
    stack.scatter_(2, pos.long()[..., None], val[..., None])


def _gather(stack, pos):
    return torch.gather(stack, 2, pos.long()[..., None])[..., 0]


def ablate_v8_plain(node, tri, o, d, variant: str, iters: int):
    """Plain version: t f32[P,8,128] after `iters` iterations, lanes as
    [P, 8, 128] tensors and chain state as [P, 8] tensors."""
    if variant not in VARIANTS:
        raise ValueError(f"ablate_v8: unknown variant {variant!r}")
    PLAIN_CALLS["probe_v8"] += 1
    fetch, leaf, slab_on, reduce_on, sort_on, scalar_on = (
        variant != v for v in VARIANTS[1:])
    n_nodes, n_trirows = node.shape[0], tri.shape[0]
    dev, P = o.device, o.shape[0]
    ov, dv, iv = common.rays(o, d)
    i32 = dict(dtype=torch.int32, device=dev)
    chain = torch.arange(P_SUB, **i32).expand(P, P_SUB)
    ntask, ltask = chain.clone(), chain.clone()
    sp, lsp = torch.zeros((P, P_SUB), **i32), torch.zeros((P, P_SUB), **i32)
    ispare = torch.full((P, P_SUB), SPARE_NONE, **i32)
    lspare = ispare.clone()
    stack = torch.zeros((P, P_SUB, STACK_CAP), **i32)
    lstack = torch.zeros((P, P_SUB, STACK_CAP), **i32)
    t_best = torch.full((P, P_SUB, P_LANE), float(BIG), dtype=torch.float32, device=dev)
    best = torch.full((P, P_SUB, P_LANE), int(NONE), **i32)
    zero = torch.zeros((P, P_SUB), **i32)
    none = torch.full((P, P_SUB), int(NONE), **i32)
    empty16 = torch.full((P, P_SUB), EMPTY16, **i32)

    def low16(x):
        return x & EMPTY16

    def consume(x):
        return ((x >> 16) & EMPTY16) | SPARE_HIGH

    for i in range(iters):
        nt, lt = ntask, ltask
        if fetch:
            nrec = node[torch.where(nt >= 0, nt, zero).long()][..., 0:7 * K]
        else:
            nrec = node[0, 0:7 * K].expand(P, P_SUB, 7 * K)
        ch8 = f2i(nrec[..., 6 * K:7 * K])

        if leaf:
            trow = tri[torch.where(lt >= 0, lt, zero).long()]
            for k in range(8):
                trec = trow[..., k * TRI_STRIDE:(k + 1) * TRI_STRIDE, None]
                ids = f2i(trec[..., 9:11, :])
                t_best, best = common.mt_record(tuple(trec[..., c, :] for c in range(9)),
                                                ids[..., 0, :], ov, dv, t_best, best)

        if slab_on:
            hks, tks = [], []
            for k in range(K):
                hk, tk = common.slab(tuple(nrec[..., k * 6 + j, None] for j in range(6)),
                                     ov, iv, t_best)
                hks.append(hk)
                tks.append(tk)
        else:
            m = (ov[0] + i) > 0.5
            hks, tks = [m] * K, [ov[0]] * K

        if reduce_on:
            reps = [torch.where(hks[k], tks[k], big_like(tks[k])).amin(dim=2) for k in range(K)]
            packs = [(hks[j].to(torch.int32) + (hks[j + 1].to(torch.int32) << 16))
                     .sum(dim=2, dtype=torch.int32) for j in range(0, K, 2)]
        else:
            reps = [tks[k][..., 0] for k in range(K)]
            packs = [hks[j][..., 0].to(torch.int32) * 65537 for j in range(0, K, 2)]

        anyk = torch.stack([c for p2 in packs for c in (p2 & 0xFFFF, p2 >> 16)], -1) > 0
        valid = anyk & (ch8 != NONE)
        rep4 = torch.stack(reps, -1)
        is_leaf4 = ch8 <= -2
        k_int = torch.where(valid & ~is_leaf4, rep4, big_like(rep4))
        k_leaf = torch.where(valid & is_leaf4, rep4, big_like(rep4))

        ki, ci = list(k_int.unbind(-1)), list(ch8.unbind(-1))
        kl, cl = list(k_leaf.unbind(-1)), list(ch8.unbind(-1))
        if sort_on:
            for kc, cc in ((ki, ci), (kl, cl)):
                for a, b in SORT_PAIRS[K]:
                    sw = kc[a] > kc[b]
                    kc[a], kc[b] = torch.where(sw, kc[b], kc[a]), torch.where(sw, kc[a], kc[b])
                    cc[a], cc[b] = torch.where(sw, cc[b], cc[a]), torch.where(sw, cc[a], cc[b])
        n_int = sum((ki[k] < BIG).to(torch.int32) for k in range(K))
        n_leaf = sum((kl[k] < BIG).to(torch.int32) for k in range(K))
        ci_e = [torch.where(ki[k] < BIG, ci[k].abs(), empty16) for k in range(1, K)] + [empty16]
        cl_e = [torch.where(kl[k] < BIG, cl[k].abs(), empty16) for k in range(1, K)] + [empty16]
        n_pairs = K // 2
        pair_i = [ci_e[2 * e] | (ci_e[2 * e + 1] << 16) for e in range(n_pairs)]
        pair_l = [cl_e[2 * e] | (cl_e[2 * e + 1] << 16) for e in range(n_pairs)]
        lA_col, desc_col = cl[0].abs(), ci[0].abs()

        if scalar_on:
            stall = lsp >= STACK_CAP - 4 - K
            nh_i = torch.where(~stall, n_int, zero)
            nh_l = torch.where(~stall, n_leaf, zero)

            spare = ispare
            has_spare = low16(spare) != EMPTY16
            ne = nh_i >> 1
            spare_push = has_spare & (ne > 0)
            _scatter(stack, sp, spare)
            sp_eff = sp + spare_push.to(torch.int32)
            for e in range(n_pairs - 1, -1, -1):
                _scatter(stack, sp_eff + (ne - 1 - e).clamp_min(0), pair_i[e])
            new_sp = torch.clamp_max(sp_eff + ne, STACK_CAP - 4)
            desc = torch.where(nh_i > 0, desc_col, none)
            spare1 = torch.where(spare_push, torch.full_like(spare, SPARE_NONE), spare)
            has_spare1 = has_spare & ~spare_push
            use_spare = (desc == NONE) & has_spare1
            do_pop = (desc == NONE) & ~has_spare1 & (new_sp > 0)
            popped = _gather(stack, (new_sp - 1).clamp_min(0))
            nxt = torch.where(stall, nt, torch.where(desc != NONE, desc, torch.where(
                use_spare, low16(spare1), torch.where(do_pop, low16(popped), none))))
            ispare = torch.where(use_spare, consume(spare1),
                                 torch.where(do_pop, consume(popped), spare1))
            ntask = (nxt.abs() + i) % n_nodes
            sp = torch.where(do_pop, new_sp - 1, new_sp.clamp_max(STACK_CAP // 2))

            l_has = low16(lspare) != EMPTY16
            nle = nh_l >> 1
            l_spush = l_has & (nle > 0)
            _scatter(lstack, lsp, lspare)
            lsp_eff = lsp + l_spush.to(torch.int32)
            for e in range(n_pairs - 1, -1, -1):
                _scatter(lstack, lsp_eff + (nle - 1 - e).clamp_min(0), pair_l[e])
            new_lsp = torch.clamp_max(lsp_eff + nle, STACK_CAP - 4)
            lt0 = torch.where(nh_l > 0, lA_col, none)
            lspare1 = torch.where(l_spush, torch.full_like(lspare, SPARE_NONE), lspare)
            l_has1 = l_has & ~l_spush
            l_use = (lt0 == NONE) & l_has1
            l_pop = (lt0 == NONE) & ~l_has1 & (new_lsp > 0)
            l_popped = _gather(lstack, (new_lsp - 1).clamp_min(0))
            ltA = torch.where(lt0 != NONE, lt0, torch.where(
                l_use, low16(lspare1), torch.where(l_pop, low16(l_popped), none)))
            lspare = torch.where(l_use, consume(lspare1),
                                 torch.where(l_pop, consume(l_popped), lspare1))
            ltask = (ltA.abs() + i) % n_trirows
            lsp = torch.where(l_pop, new_lsp - 1, new_lsp.clamp_max(STACK_CAP // 2))
        else:
            ntask = (nt + 1) % n_nodes
            ltask = (lt + 1) % n_trirows

        t_best = torch.minimum(t_best, rep4[..., 0, None] + float(BIG))
    return t_best + best.to(torch.float32) * 0.0


def _check(node, tri, o, d):
    P = o.shape[0]
    cudalib.require_cuda("node", node, torch.float32)
    cudalib.require_cuda("tri", tri, torch.float32)
    if node.dim() != 2 or node.shape[1] != 128 or tri.dim() != 2 or tri.shape[1] != 128:
        raise ValueError("ablate_v8: node and tri must be f32[rows, 128]")
    if node.shape[0] < P_SUB or tri.shape[0] < P_SUB:
        raise ValueError("ablate_v8: the chains start at rows 0..7 of both tables")
    cudalib.require_aligned("node", node.data_ptr())   # rows read 16 bytes at a time
    cudalib.require_aligned("tri", tri.data_ptr())
    cudalib.require_cuda("o", o, torch.float32, (P, 3, P_SUB, P_LANE))
    cudalib.require_cuda("d", d, torch.float32, (P, 3, P_SUB, P_LANE))


def ablate_v8(node, tri, o, d, variant: str, iters: int = ITERS, w: int | None = None):
    """t f32[P,8,128] of the v8 probe body, variant `variant`: launches
    csrc/probe_v8.cu for CUDA tensors, at chain width w (1, 2 or 4; None:
    the one the entry point picks, `chosen_w`), and runs the plain version
    for CPU tensors, whose result no W changes."""
    v = VARIANTS.index(variant)
    if w is not None:
        common.require_w(w, ADMITTED_W, "ablate_v8")
    if not o.is_cuda:
        if o.device.type != "cpu":
            raise ValueError(f"ablate_v8: unsupported device {o.device}")
        return ablate_v8_plain(node, tri, o, d, variant, iters)
    _check(node, tri, o, d)
    P = o.shape[0]
    out = torch.empty((P, P_SUB, P_LANE), dtype=torch.float32, device=o.device)
    args = (node.data_ptr(), tri.data_ptr(), o.data_ptr(), d.data_ptr(), node.shape[0],
            tri.shape[0], iters, P, v)
    L = cudalib.lib()
    code = (L.rt_probe_v8(*args, out.data_ptr(), cudalib.stream_handle()) if w is None else
            L.rt_probe_v8_w(*args, w, out.data_ptr(), cudalib.stream_handle()))
    cudalib.check(code, f"probe_v8 kernel ({variant}, W {w or 'picked'})")
    LAUNCHES["probe_v8"] += 1
    return out


def chosen_w(packets: int, variant: str = "full") -> int:
    """The chain width the entry point takes for `packets` packets on the
    current card (common.pick_w on its SM count, WARPS_PER_SM)."""
    w = cudalib.lib().rt_probe_v8_pick_w(packets, VARIANTS.index(variant))
    if w <= 0:
        cudalib.check(-w, "probe_v8 pick_w")
    return w


def kernel_resources(w: int = 1) -> dict:
    """{variant: (registers per thread, local memory bytes per thread)} of
    the kernels of chain width w."""
    common.require_w(w, ADMITTED_W, "ablate_v8")
    fn = cudalib.lib().rt_probe_v8_attrs_w
    return common.kernel_attrs(lambda v, r, lb: fn(v, w, r, lb),
                               {name: v for v, name in enumerate(VARIANTS)}, "probe_v8")


def lane_ops(variant: str) -> int:
    """fp32 operations of one lane in one iteration (common.MT_OPS,
    SLAB_OPS): 8 MT records, 8 slab tests (no_slab: one add and compare),
    each child's rep-key select and min, the keep-alive add and min."""
    ops = 2 + (8 * MT_OPS if variant != "no_leaf" else 0)
    ops += K * SLAB_OPS if variant != "no_slab" else 2
    return ops + (2 * K if variant != "no_reduce" else 0)


def work(node, tri, o, variant: str, iters: int) -> dict:
    """The work a bound is taken from: bytes (each input read once, the
    output written once) and the lanes' fp32 operations."""
    P = o.shape[0]
    return dict(bytes=4 * (node.numel() + tri.numel() + 2 * o.numel() + P * P_SUB * P_LANE),
                ops=lane_ops(variant) * P * P_SUB * P_LANE * iters)


def run(iters: int = ITERS, packets: int = N_PACKETS, out=print) -> dict:
    """What the script's main() does, on the card: each variant warmed up,
    then 10 launches timed with CUDA events; prints kernel ms (median),
    ns per chain-iteration and the phase cost full − variant (registers
    and local memory those of the chain width the entry point took)."""
    common.require_card("ablate_v8")
    dev = torch.device("cuda")
    node, tri, o, d = (torch.from_numpy(a).to(dev) for a in make_inputs(packets))
    ws = {v: chosen_w(packets, v) for v in VARIANTS}
    res = {w: kernel_resources(w) for w in set(ws.values())}
    results = {}
    for v in VARIANTS:
        ms = common.median(common.time_launches(lambda: ablate_v8(node, tri, o, d, v, iters)))
        ns = ms * 1e6 / (packets * P_SUB * iters)
        rv = res[ws[v]][v]
        r = dict(ms=ms, ns_per_chain_iter=ns, num_regs=rv[0], local_bytes=rv[1], w=ws[v])
        line = f"{v:10s}: {ms:8.4f} ms  {ns:8.3f} ns/chain-iter"
        if v != "full":
            r["phase_cost_ns"] = results["full"]["ns_per_chain_iter"] - ns
            line += f"   phase cost {r['phase_cost_ns']:+8.3f} ns"
        out(line + f"   regs {rv[0]} local {rv[1]} B")
        results[v] = r
    return dict(iters=iters, packets=packets, variants=results)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    iters = int(argv[0]) if len(argv) > 0 else ITERS
    packets = int(argv[1]) if len(argv) > 1 else N_PACKETS
    run(iters, packets)
    return 0


if __name__ == "__main__":
    sys.exit(main())
