"""Does running G independent packets' chains in one loop iteration hide the
iteration's latency chain, on the card? The port of
scripts/kernel_interleave_probe.py (its `make_kernel` :37, TPU call :216).

The v5 `full` body (probes/v5_body.py) with G ∈ {1, 2, 4, 8} packets per
block: warp s runs chain s of each of the G packets, so a thread carries
G dependence chains (kernel: csrc/probe_interleave.cu). A packet's output
does not depend on G; it is the v5 `full` body's, so the plain version is
v5_body.v5_plain in mode "full". Same total work per packet for every G;
on the reference scene's 4-wide tree, 119 iterations, 128 packets by
default (where G = 8 is 16 blocks), and 1,056 packets on request (G = 8
then fills the 132 SMs with one block each).

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


def interleave(node, tri, o, d, tlim, zero_row: int, G: int, iters: int = ITERS):
    """t f32[P,8,128] of the v5 full body run G packets per block:
    launches csrc/probe_interleave.cu for CUDA tensors, runs the plain
    version for CPU tensors."""
    _check_g(G, o.shape[0])
    if not o.is_cuda:
        if o.device.type != "cpu":
            raise ValueError(f"interleave probe: unsupported device {o.device}")
        return interleave_plain(node, tri, o, d, tlim, zero_row, G, iters)
    v5_body._check(node, tri, o, d, tlim, zero_row, "full")
    P = o.shape[0]
    out = torch.empty((P, P_SUB, P_LANE), dtype=torch.float32, device=o.device)
    code = cudalib.lib().rt_probe_interleave(
        node.data_ptr(), tri.data_ptr(), o.data_ptr(), d.data_ptr(), tlim.data_ptr(), zero_row,
        iters, P, GS.index(G), out.data_ptr(), cudalib.stream_handle())
    cudalib.check(code, f"probe_interleave kernel (G={G})")
    LAUNCHES["probe_interleave"] += 1
    return out


def kernel_resources(gs=GS) -> dict:
    """{G: (registers per thread, local memory bytes per thread)}."""
    return common.kernel_attrs(cudalib.lib().rt_probe_interleave_attrs,
                               {G: GS.index(G) for G in gs}, "probe_interleave")


def work(node, tri, o, iters: int) -> dict:
    """Bytes and fp32 operations: the v5 full body's for every G."""
    return v5_body.work(node, tri, o, "full", iters)


def run(iters: int = ITERS, packets: int = N_PACKETS, tables=None, gs=GS, out=print) -> dict:
    """What the script's main() does, on the card: the reference scene's v5
    tables (or `tables` = (node, tri, zero_row)), `packets` x 1024 seeded
    rays, then each G warmed up and 10 launches timed with CUDA events;
    prints kernel ms (median), ns per chain-iteration, the speed-up over
    G = 1, registers and local memory."""
    common.require_card("interleave_probe")
    dev = torch.device("cuda")
    node, tri, zero_row = tables if tables is not None else v5_body.reference_tables()
    o, d, tlim = (torch.from_numpy(a).to(dev) for a in v5_body.make_rays(packets))
    node, tri = node.to(dev).contiguous(), tri.to(dev).contiguous()
    res = kernel_resources(gs)
    results = {}
    for G in gs:
        ms = common.median(common.time_launches(
            lambda: interleave(node, tri, o, d, tlim, zero_row, G, iters)))
        ns = ms * 1e6 / (packets * P_SUB * iters)
        r = dict(ms=ms, ns_per_chain_iter=ns, blocks=packets // G, num_regs=res[G][0],
                 local_bytes=res[G][1])
        line = f"G={G}: {ms:8.4f} ms  {ns:8.3f} ns/chain-iter  {packets // G:5d} blocks"
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
