"""Unit costs of per-chain scalar work inside a loop that also does vector
work, on the card: the port of scripts/scalar_cost_probe.py (its
`make_kernel` :37, TPU call :122).

Variants, as the script's main() runs them (403 iterations, 256 packets of
f32[8, 128] drawn uniform in [0.1, 1) from seed 0): baseline, baseline2x
(twice the iterations: the time must scale), alu32, smem16, extract8,
vsort (kernel: csrc/probe_scalar.cu, which says how each unit maps onto a
warp). A variant's ns per iteration minus baseline's is its unit's cost.

The kernel and the plain version return (acc, sc, codes): the script's
output acc f32[P, 8, 128], and a witness of the scalar work, which acc does
not show: sc int32[P] after the last iteration and, in vsort, the last
iteration's sorted codes int32[P, 8, 8]. smem16's 64-entry table carries
from packet to packet as in the script; `smem16_tables` gives each packet's
starting table (on the card a pre-pass kernel, timed apart, that runs every
packet's chain at once and then scans over the packets). On the card a packet is a block of W warps
(ADMITTED_W; `chosen_w` picks one per mode).

    python -m raytracer_tpu_torch.probes.scalar_cost [iters]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from raytracer_tpu_torch.probes import common
from raytracer_tpu_torch.probes.v5_tables import P_LANE, P_SUB
from raytracer_tpu_torch.utils import cudalib

ITERS, N_PACKETS = 403, 256
TABLE = 64
MODES = ("baseline", "alu32", "smem16", "extract8", "vsort")   # csrc/probe_scalar.cu order
VARIANTS = ("baseline", "baseline2x", "alu32", "smem16", "extract8", "vsort")
# vsort's network over the 8 columns (the script's 19 compare-exchanges).
PAIRS = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7), (1, 2), (5, 6),
         (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5), (1, 2), (3, 4), (5, 6))
LAUNCHES = {"probe_scalar": 0, "probe_scalar_tables": 0}
PLAIN_CALLS = {"probe_scalar": 0}
ADMITTED_W = (1, 2, 4, 8)   # warps per packet, every mode (csrc/probe_scalar.cu)
# The W `scalar_cost` takes for each mode: the fastest in phase 13 of
# chip_smoke.py, which times every mode at every W (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md §6).
CHOSEN_W = {"baseline": 8, "alu32": 4, "smem16": 4, "extract8": 8, "vsort": 2}


def variant(name: str, iters: int = ITERS) -> tuple[str, int]:
    """(kernel mode, iterations) of a variant: baseline2x is baseline at
    twice the iterations."""
    if name not in VARIANTS:
        raise ValueError(f"scalar cost probe: unknown variant {name!r}")
    return (name.replace("2x", ""), 2 * iters if name.endswith("2x") else iters)


def make_input(packets: int = N_PACKETS, seed: int = 0) -> np.ndarray:
    """The script's first input: f32[packets, 8, 128] uniform in [0.1, 1)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 1.0, (packets, P_SUB, P_LANE)).astype(np.float32)


def smem16_chain(packets: int, iters: int):
    """smem16's scalar chain over the packets in order, in Python integers:
    (tables int32[packets, 64], the table each packet starts from, and sc
    int32[packets, iters + 1], sc before each iteration and after the
    last). The table starts as zeros: packet 0 reads only entries it wrote
    in the same iteration, so its start does not matter."""
    tab = [0] * TABLE
    tables = np.zeros((packets, TABLE), np.int32)
    seq = np.zeros((packets, iters + 1), np.int64)
    for p in range(packets):
        tables[p] = tab
        sc = seq[p, 0] = p
        for it in range(iters):
            for k in range(16):
                tab[(sc + k) & (TABLE - 1)] = sc + k
            sc = seq[p, it + 1] = tab[it & (TABLE - 1)]
    if seq.max() >= 2**31 - 16:
        raise ValueError("scalar cost probe: smem16's chain leaves int32")
    return tables, seq.astype(np.int32)


def smem16_tables(packets: int, iters: int, device) -> torch.Tensor:
    """Each packet's starting smem16 table, int32[packets, 64]: the pre-pass
    kernel on the card, smem16_chain on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.from_numpy(smem16_chain(packets, iters)[0])
    if device.type != "cuda":
        raise ValueError(f"scalar cost probe: unsupported device {device}")
    lib = cudalib.lib()
    tables = torch.empty((packets, TABLE), dtype=torch.int32, device=device)
    scratch = torch.empty((lib.rt_probe_scalar_tables_scratch(packets),), dtype=torch.int32,
                          device=device)
    cudalib.check(lib.rt_probe_scalar_tables(packets, iters, tables.data_ptr(),
                                             scratch.data_ptr(), cudalib.stream_handle()),
                  "probe_scalar tables kernel")
    LAUNCHES["probe_scalar_tables"] += 1
    return tables


def scalar_plain(x, mode: str, iters: int):
    """Plain version: (acc f32[P,8,128], sc int32[P], codes int32[P,8,8] in
    vsort else None), all packets at once; smem16's sc comes from
    smem16_chain, which runs the packets in order."""
    if mode not in MODES:
        raise ValueError(f"scalar cost probe: unknown mode {mode!r}")
    PLAIN_CALLS["probe_scalar"] += 1
    P, dev = x.shape[0], x.device
    acc = x.clone()
    sc = torch.arange(P, dtype=torch.int32, device=dev)
    seq = torch.from_numpy(smem16_chain(P, iters)[1]).to(dev) if mode == "smem16" else None
    codes = None
    for it in range(iters):
        a = acc * 1.000001 + 0.5 + (sc.to(torch.float32) * 1e-9)[:, None, None]
        b = torch.minimum(a, acc)
        c = torch.maximum(a, b)
        acc = torch.where(c > acc, b, c) + 1e-7
        if mode == "alu32":
            for _ in range(32):
                sc = (sc * 3 + 1) & 0xFFFF
        elif mode == "smem16":
            sc = seq[:, it + 1]
        elif mode == "extract8":
            t = sc
            for s in range(P_SUB):
                t = t + common.f2i(acc[:, s, (3 * s) % 8])
            sc = t & 0xFFFF
        elif mode == "vsort":
            kt = [acc[:, :, k] for k in range(8)]
            kc = [common.f2i(acc[:, :, 8 + k] * 1000.0) for k in range(8)]
            for i, j in PAIRS:
                sw = kt[i] > kt[j]
                kt[i], kt[j] = torch.where(sw, kt[j], kt[i]), torch.where(sw, kt[i], kt[j])
                kc[i], kc[j] = torch.where(sw, kc[j], kc[i]), torch.where(sw, kc[i], kc[j])
            tot = kt[0]
            for k in range(1, 8):
                tot = tot + kt[k]
            acc = acc + (tot * 1e-9)[..., None]
            codes = torch.stack(kc, -1)
    return acc, sc, codes


def chosen_w(mode: str) -> int:
    """The warps per packet `scalar_cost` takes for `mode` when no W is
    asked for (CHOSEN_W, the only copy of the rule)."""
    return CHOSEN_W[mode]


def scalar_cost(x, mode: str, iters: int = ITERS, tables=None, w: int | None = None):
    """(acc, sc, codes) of `iters` iterations of `mode` from x f32[P,8,128]:
    launches csrc/probe_scalar.cu for a CUDA tensor at w warps per packet
    (one of ADMITTED_W; None: chosen_w) (smem16 takes `tables`, or makes
    them with the pre-pass kernel), runs the plain version for a CPU tensor,
    whose result no W changes."""
    if mode not in MODES:
        raise ValueError(f"scalar cost probe: unknown mode {mode!r}")
    if w is not None:
        common.require_w(w, ADMITTED_W, f"scalar cost probe ({mode})")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"scalar cost probe: unsupported device {x.device}")
        return scalar_plain(x, mode, iters)
    P = x.shape[0]
    cudalib.require_cuda("x", x, torch.float32, (P, P_SUB, P_LANE))
    if mode == "smem16":
        if tables is None:
            tables = smem16_tables(P, iters, x.device)
        cudalib.require_cuda("tables", tables, torch.int32, (P, TABLE))
    out = torch.empty_like(x)
    sc = torch.empty((P,), dtype=torch.int32, device=x.device)
    codes = (torch.empty((P, P_SUB, 8), dtype=torch.int32, device=x.device)
             if mode == "vsort" else None)
    code = cudalib.lib().rt_probe_scalar(
        x.data_ptr(), tables.data_ptr() if mode == "smem16" else None, iters, P,
        MODES.index(mode), w or chosen_w(mode), out.data_ptr(), sc.data_ptr(),
        codes.data_ptr() if codes is not None else None, cudalib.stream_handle())
    cudalib.check(code, f"probe_scalar kernel ({mode})")
    LAUNCHES["probe_scalar"] += 1
    return out, sc, codes


def kernel_resources(modes=MODES + ("tables",), w: int | None = None) -> dict:
    """{mode: (registers per thread, local memory bytes per thread)} at w
    warps per packet (None: each mode's chosen_w); "tables" is smem16's
    pre-pass."""
    fn = cudalib.lib().rt_probe_scalar_attrs
    out = {}
    for mode in modes:
        i = len(MODES) if mode == "tables" else MODES.index(mode)
        wm = 1 if mode == "tables" else (w or chosen_w(mode))
        out.update(common.kernel_attrs(lambda j, r, b, wm=wm: fn(j, wm, r, b), {mode: i},
                                       "probe_scalar"))
    return out


def work(mode: str, packets: int, iters: int) -> dict:
    """Bytes (x read once, acc and the witness written once, smem16's
    tables read once) and operations, counted from the code. fp32 per
    element and iteration: the vector workload's mul, 2 adds, min, max,
    compare and add (7); per packet and iteration: sc's conversion and
    scale (2). Each mode's own, per packet and iteration: alu32 32 x (mul,
    add, and) int32; smem16 16 x (add, and) int32; extract8 8 conversions,
    8 adds and an and, int32; vsort 8 mul and 8 conversions, 19 compares,
    7 adds and a scale fp32, and one add per element."""
    n = P_SUB * P_LANE
    fp32 = (7 * n + 2) * packets * iters
    int32 = {"alu32": 96, "smem16": 32, "extract8": 17}.get(mode, 0) * packets * iters
    if mode == "vsort":
        fp32 += (8 + 8 + 19 + 7 + 1 + n) * packets * iters
    nbytes = 4 * packets * (2 * n + 1 + (TABLE if mode == "smem16" else 0)
                            + (64 if mode == "vsort" else 0))
    return dict(bytes=nbytes, fp32_ops=fp32, int32_ops=int32)


def tables_work(packets: int, iters: int) -> dict:
    """The smem16 tables pre-pass (csrc/probe_scalar.cu
    probe_scalar_tables_kernel): bytes (the tables written once), int32
    operations (per packet and iteration smem16's 16 x (add, and)), and the
    dependent instructions of its longest chain by kind, at least: a
    packet's iterations (2 integer ops each: the load's offset (e - sc) mod
    64, then sc plus it), then the scan of C_p, 32 packets a round (each 5
    shuffle-and-compose steps and the round's hand-over: 6 shuffles and 6
    integer ops)."""
    rounds = -(-max(packets - 1, 0) // 32)
    return dict(bytes=4 * packets * TABLE, int32_ops=32 * packets * iters,
                dep_alu=2 * iters + 6 * rounds, dep_shfl=6 * rounds)


def run(iters: int = ITERS, packets: int = N_PACKETS, out=print) -> dict:
    """What the script's main() does, on the card: one seeded input, the
    smem16 pre-pass (timed apart), then each variant at its chosen W warmed
    up and 10 launches timed with CUDA events; prints kernel ms (median),
    ns per packet-iteration (the script's unit), ns per iteration of a
    packet (all packets run at once) and its excess over baseline,
    registers and local memory."""
    common.require_card("scalar_cost")
    dev = torch.device("cuda")
    x = torch.from_numpy(make_input(packets)).to(dev)
    res = kernel_resources()
    tables = {}

    def prepass():
        tables["t"] = smem16_tables(packets, iters, dev)

    ms_tables = common.median(common.time_launches(prepass))
    out(f"smem16 tables pre-pass: {ms_tables:8.4f} ms ({packets} packets x {iters} iterations, "
        f"each packet's chain at once, then the scan; not in smem16's time)   regs "
        f"{res['tables'][0]} local {res['tables'][1]} B")
    results = {}
    for name in VARIANTS:
        mode, it = variant(name, iters)
        ms = common.median(common.time_launches(
            lambda: scalar_cost(x, mode, it, tables["t"] if mode == "smem16" else None)))
        r = dict(ms=ms, iters=it, w=chosen_w(mode), ns_per_packet_iter=ms * 1e6 / (packets * it),
                 ns_per_iter=ms * 1e6 / it, num_regs=res[mode][0], local_bytes=res[mode][1])
        line = (f"{name:10s}: {ms:8.4f} ms  {r['ns_per_packet_iter']:8.3f} ns/packet-iter  "
                f"{r['ns_per_iter']:8.2f} ns/iter  W{r['w']}")
        if name not in ("baseline", "baseline2x"):
            r["over_baseline_ns"] = r["ns_per_iter"] - results["baseline"]["ns_per_iter"]
            line += f"   +{r['over_baseline_ns']:7.2f} ns over baseline"
        out(line + f"   regs {res[mode][0]} local {res[mode][1]} B")
        results[name] = r
    return dict(script="scalar_cost", iters=iters, packets=packets, tables_ms=ms_tables,
                variants=results)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else ITERS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
