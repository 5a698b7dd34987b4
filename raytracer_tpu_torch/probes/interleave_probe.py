"""Does running G independent packets' chains in one loop iteration hide the
iteration's latency chain, on the card? The port of
scripts/kernel_interleave_probe.py (its `make_kernel` :37, TPU call :216).

The v5 `full` body (probes/v5_body.py) with G ∈ {1, 2, 4, 8} chains per
thread: a chain group of W warps (W = 1, 2 or 4) carries chain s of each
of G packets, so a thread carries G dependence chains, 4 / W lanes of each
(kernel: csrc/probe_interleave.cu). A packet's output does not depend on
G or W; it is the v5 `full` body's, so the plain version is
v5_body.v5_plain in mode "full". Same total work per packet for every G;
on the reference scene's 4-wide tree, 119 iterations, 128 packets by
default, and 1,056 packets on request (8 blocks of 8 warps per SM at G =
1 and W = 1). The wrapper picks W from G alone (`chosen_w`).

    python -m raytracer_tpu_torch.probes.interleave_probe [iters] [packets]
"""

from __future__ import annotations

import sys

import torch

from raytracer_tpu_torch.probes import common, v5_body
from raytracer_tpu_torch.probes.v5_tables import P_LANE, P_SUB
from raytracer_tpu_torch.utils import cudalib

GS = (1, 2, 4, 8)
ITERS, N_PACKETS = v5_body.ITERS, v5_body.N_PACKETS
# The chain widths each G's kernel is built at (csrc/probe_interleave.cu
# admits): those at which a thread's 4 G / W lanes fit in its registers
# without spilling.
ADMITTED_W = {G: tuple(w for w in common.CHAIN_WIDTHS if 4 * G // w <= 16) for G in GS}
LAUNCHES = {"probe_interleave": 0}
PLAIN_CALLS = {"probe_interleave": 0}


def _check_g(G: int, packets: int) -> None:
    if G not in GS:
        raise ValueError(f"interleave probe: G must be one of {GS}, got {G}")
    if packets % G:
        raise ValueError(f"interleave probe: {packets} packets is not a multiple of G={G}")


def interleave_plain(node, tri, o, d, tlim, zero_row: int, G: int, iters: int):
    """Plain version: the v5 full body's t f32[P,8,128] (G only groups
    packets, each packet's chains are independent of the others)."""
    _check_g(G, o.shape[0])
    PLAIN_CALLS["probe_interleave"] += 1
    return v5_body.v5_plain(node, tri, o, d, tlim, zero_row, "full", iters)


def interleave(node, tri, o, d, tlim, zero_row: int, G: int, iters: int = ITERS,
               w: int | None = None):
    """t f32[P,8,128] of the v5 full body run G chains per thread:
    launches csrc/probe_interleave.cu for CUDA tensors, at chain width w
    (one of ADMITTED_W[G]; None: `chosen_w`), and runs the plain version
    for CPU tensors, whose result no G or W changes."""
    _check_g(G, o.shape[0])
    if w is not None:
        common.require_w(w, ADMITTED_W[G], f"interleave probe (G={G})")
    if not o.is_cuda:
        if o.device.type != "cpu":
            raise ValueError(f"interleave probe: unsupported device {o.device}")
        return interleave_plain(node, tri, o, d, tlim, zero_row, G, iters)
    v5_body._check(node, tri, o, d, tlim, zero_row, "full")
    P = o.shape[0]
    out = torch.empty((P, P_SUB, P_LANE), dtype=torch.float32, device=o.device)
    args = (node.data_ptr(), tri.data_ptr(), o.data_ptr(), d.data_ptr(), tlim.data_ptr(), zero_row,
            iters, P, GS.index(G))
    w = chosen_w(G) if w is None else w
    code = cudalib.lib().rt_probe_interleave_w(*args, w, out.data_ptr(), cudalib.stream_handle())
    cudalib.check(code, f"probe_interleave kernel (G={G}, W {w})")
    LAUNCHES["probe_interleave"] += 1
    return out


def chosen_w(G: int) -> int:
    """The chain width `interleave` takes at G, at any packet count: the
    widest G admits that leaves a thread two lanes or more (4 G / W >= 2),
    W = 2 at G = 1 and W = 4 above; the fastest W of each G at 128 and at
    1,056 packets on an H100 (chip_smoke.py phase 13 times every W)."""
    return max(w for w in ADMITTED_W[G] if 4 * G // w >= 2)


def kernel_resources(gs=GS, ws=None) -> dict:
    """{G: (registers per thread, local memory bytes per thread)} of each
    G's kernel at chain width ws[G] (ws None: each G's narrowest)."""
    ws = ws or {G: min(ADMITTED_W[G]) for G in gs}
    for G in gs:
        common.require_w(ws[G], ADMITTED_W[G], f"interleave probe (G={G})")
    fn = cudalib.lib().rt_probe_interleave_attrs_w
    return {G: common.kernel_attrs(lambda gi, r, lb: fn(gi, ws[G], r, lb), {G: GS.index(G)},
                                   "probe_interleave")[G] for G in gs}


def work(node, tri, o, iters: int) -> dict:
    """Bytes and fp32 operations: the v5 full body's for every G."""
    return v5_body.work(node, tri, o, "full", iters)


def run(iters: int = ITERS, packets: int = N_PACKETS, tables=None, gs=GS, out=print) -> dict:
    """What the script's main() does, on the card: the reference scene's v5
    tables (or `tables` = (node, tri, zero_row)), `packets` x 1024 seeded
    rays, then each G warmed up and 10 launches timed with CUDA events at
    the chain width the entry point picks; prints kernel ms (median), ns
    per chain-iteration, the speed-up over G = 1, W, warps, registers and
    local memory."""
    common.require_card("interleave_probe")
    dev = torch.device("cuda")
    node, tri, zero_row = tables if tables is not None else v5_body.reference_tables()
    o, d, tlim = (torch.from_numpy(a).to(dev) for a in v5_body.make_rays(packets))
    node, tri = node.to(dev).contiguous(), tri.to(dev).contiguous()
    ws = {G: chosen_w(G) for G in gs}
    res = kernel_resources(gs, ws)
    results = {}
    for G in gs:
        ms = common.median(common.time_launches(
            lambda: interleave(node, tri, o, d, tlim, zero_row, G, iters)))
        ns = ms * 1e6 / (packets * P_SUB * iters)
        warps = packets * P_SUB * ws[G] // G
        r = dict(ms=ms, ns_per_chain_iter=ns, w=ws[G], warps=warps, num_regs=res[G][0],
                 local_bytes=res[G][1])
        line = f"G={G}: {ms:8.4f} ms  {ns:8.3f} ns/chain-iter  W {ws[G]}  {warps:5d} warps"
        if G != gs[0]:
            r["speedup"] = results[gs[0]]["ms"] / ms
            line += f"   G={gs[0]} / G={G} {r['speedup']:6.3f}x"
        out(line + f"   regs {res[G][0]} local {res[G][1]} B")
        results[G] = r
    return dict(script="interleave_probe", iters=iters, packets=packets, gs=results)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    iters = int(argv[0]) if len(argv) > 0 else ITERS
    packets = int(argv[1]) if len(argv) > 1 else N_PACKETS
    run(iters, packets)
    return 0


if __name__ == "__main__":
    sys.exit(main())
