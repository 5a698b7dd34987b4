"""Pieces the probe bodies share: the plain versions' slab test and
Möller–Trumbore record (the scripts' `slab` and `mt_record`, term for term),
the float-to-int conversion of float-encoded ids, the timing and
counting of kernel launches on the card, and the latency calibration of
the chain probes' dependence bounds."""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from raytracer_tpu_torch.probes.v5_tables import BIG, P_SUB, TRI_STRIDE
from raytracer_tpu_torch.utils import cudalib

INT_MAX = 2**31 - 1
# fp32 operations (arithmetic and compares, not selects) of one lane,
# counted from the code: a Möller–Trumbore record (`mt_record` here,
# csrc/probe.cuh, csrc/traverse.cuh:62-92) is 55 — hx..hz 9, a 5, the |a|
# test 2, f 2, s 3, u 6 and its tests 2, q 9, v 6 and its tests 3, t 6
# and its tests 2; a slab test (`slab`, traverse.cuh:100-112) is 25 — 6
# sub, 6 mul, 6 min/max of the axis pairs, 3 max for tmin, 3 min for
# tmax, the compare.
MT_OPS, SLAB_OPS = 55, 25


def f2i(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 as JAX's astype and the card's cvt.rzi.s32.f32
    convert: toward zero, saturating at the int32 range, NaN → 0 (torch's
    own conversion is undefined out of range)."""
    i = x.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    i = torch.where(x >= 2147483648.0, torch.full_like(i, INT_MAX), i)
    return torch.where(torch.isnan(x), torch.zeros_like(i), i)


def slab(b, o, inv, t_best):
    """(hit, tmin) of lanes against one box per chain: b is six [..., 1]
    columns (min xyz, max xyz), o / inv three lane tensors. min/max
    propagate NaN (jnp's and torch's), so a NaN plane distance is a miss."""
    lx, ly, lz, hx, hy, hz = b
    ox, oy, oz = o
    ix, iy, iz = inv
    t0x, t1x = (lx - ox) * ix, (hx - ox) * ix
    t0y, t1y = (ly - oy) * iy, (hy - oy) * iy
    t0z, t1z = (lz - oz) * iz, (hz - oz) * iz
    tmin = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                         torch.maximum(torch.minimum(t0z, t1z), torch.full_like(t0z, 1e-3)))
    tmax = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                         torch.minimum(torch.maximum(t0z, t1z), t_best))
    return tmax > tmin, tmin


def mt_record(fields, prim, o, d, t_best, best):
    """One Möller–Trumbore record (fields: nine [..., 1] columns v0, e1,
    e2) against every lane; a strictly closer hit with t >= 1e-3 updates
    (t_best, best)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = fields
    ox, oy, oz = o
    dx, dy, dz = d
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    ok = a.abs() >= 1e-8
    f = 1.0 / torch.where(ok, a, torch.ones_like(a))
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    ok = ok & (u >= 0.0) & (u <= 1.0)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = ok & (t >= 1e-3) & (t < t_best)
    return torch.where(ok, t, t_best), torch.where(ok, prim, best)


def mt_record6(fields, prim, matid, o, d, state):
    """The 6-field mt_record of the v6 and morph scripts: one record (nine [..., 1] columns
    v0, e1, e2) against every lane; a strictly closer hit with t >= 1e-3
    takes t, the ids and cross(e1, e2)."""
    t_best, best, mat, nx, ny, nz = state
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = fields
    ox, oy, oz = o
    dx, dy, dz = d
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    ok = a.abs() >= 1e-8
    f = 1.0 / torch.where(ok, a, torch.ones_like(a))
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    ok = ok & (u >= 0.0) & (u <= 1.0)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = ok & (t >= 1e-3) & (t < t_best)
    return (torch.where(ok, t, t_best), torch.where(ok, prim, best),
            torch.where(ok, matid, mat), torch.where(ok, e1y * e2z - e1z * e2y, nx),
            torch.where(ok, e1z * e2x - e1x * e2z, ny), torch.where(ok, e1x * e2y - e1y * e2x, nz))


def mt_row8(row, o, d, state):
    """The 8 records of a triangle row per chain, row [..., 128]."""
    for k in range(8):
        trec = row[..., k * TRI_STRIDE:(k + 1) * TRI_STRIDE, None]
        ids = f2i(trec[..., 9:11, :])
        state = mt_record6(tuple(trec[..., c, :] for c in range(9)), ids[..., 0, :],
                           ids[..., 1, :], o, d, state)
    return state


def sort4(keys, codes):
    """The scripts' 4-key sort network (kernel_v6_probe.py vsort4 :275-284,
    kernel_morph.py :242-248): keys ascending, a swap only on a
    strictly greater key."""
    kc, cc = list(keys), list(codes)
    for i, j in ((0, 2), (1, 3), (0, 1), (2, 3), (1, 2)):
        sw = kc[i] > kc[j]
        kc[i], kc[j] = torch.where(sw, kc[j], kc[i]), torch.where(sw, kc[i], kc[j])
        cc[i], cc[j] = torch.where(sw, cc[j], cc[i]), torch.where(sw, cc[i], cc[j])
    return kc, cc


def root_hit(node, o, inv, t_best):
    """Lanes that hit the union of the root's child boxes (node row 0's
    record 0 in the v5 / v6 layouts): the min side the min of the four
    children's raw bounds, the max side the max of those whose max x is
    above -BIG (-BIG for the others); jnp's NaN-propagating min / max."""
    rec0 = node[0, 0:24]
    neg = torch.tensor(-float(BIG), dtype=torch.float32, device=node.device)
    lo = [torch.minimum(torch.minimum(rec0[c], rec0[6 + c]),
                        torch.minimum(rec0[12 + c], rec0[18 + c])) for c in range(3)]
    hi = []
    for c in range(3):
        v = [torch.where(rec0[6 * k + 3] > -float(BIG), rec0[6 * k + 3 + c], neg)
             for k in range(4)]
        hi.append(torch.maximum(torch.maximum(v[0], v[1]), torch.maximum(v[2], v[3])))
    return slab((*lo, *hi), o, inv, t_best)[0]


def rays(o: torch.Tensor, d: torch.Tensor):
    """Lane tensors (o xyz, d xyz, 1/d xyz) of o, d f32[P, 3, 8, 128]."""
    ov, dv = o.unbind(1), d.unbind(1)
    return ov, dv, tuple(1.0 / c for c in dv)


def big_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, float(BIG))


def require_card(what: str) -> None:
    """Entry points measure the card: without one they stop."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{what}: torch.cuda.is_available() is false; this needs a CUDA card")


# P-v8, the v5 body, P-morph and P-interleave spread a chain over W warps
# (csrc/probe.cuh): the widths their kernels are built for.
CHAIN_WIDTHS = (1, 2, 4)


def pick_w(packets: int, sms: int, admitted, warps_per_sm: int) -> int:
    """The chain width rt_probe_v8 and rt_probe_v5 take for `packets`
    packets on a card of `sms` SMs: the widest admitted W whose packets * 8
    * W warps stay within `warps_per_sm` per SM (each kernel's own,
    ablate_v8.WARPS_PER_SM and v5_body.WARPS_PER_SM), else 1: every warp of
    a chain repeats the chain-uniform work, so a full card takes W = 1."""
    for w in (4, 2):
        if w in admitted and packets * P_SUB * w <= warps_per_sm * sms:
            return w
    return 1


def sm_count(device=None) -> int:
    """The SMs of a CUDA device (the current one by default)."""
    return torch.cuda.get_device_properties(
        torch.cuda.current_device() if device is None else device).multi_processor_count


def require_w(w: int, admitted, what: str) -> None:
    """Raise unless chain width w is admitted: an entry point never takes
    another W than the one asked for."""
    if w not in admitted:
        raise ValueError(f"{what}: chain width {w} is not admitted (admitted: {admitted})")


TIMED_LAUNCHES = 10


def time_launches(fn) -> list[float]:
    """Milliseconds of each of TIMED_LAUNCHES calls of fn after one warm-up
    call, each between its own pair of CUDA events."""
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(TIMED_LAUNCHES)]
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in evs]


def median(xs) -> float:
    return float(np.median(xs))


LATENCY_STEPS = 1 << 20


def latency_clocks() -> dict:
    """{"alu": clocks, "shfl": clocks}: the latency of one dependent integer
    ALU operation (a step of csrc/probe_latency.cu's kind 0 is two: an add,
    then a xor) and of one shuffle on the current card, the fewest SM
    clocks (clock64 around the loop) of three runs over LATENCY_STEPS steps.
    The dependence bounds of P-vstack and the P-scalar tables pre-pass
    multiply their chains by these."""
    lib = cudalib.lib()
    clocks = torch.zeros((1,), dtype=torch.int64, device="cuda")
    sink = torch.zeros((32,), dtype=torch.int32, device="cuda")
    out = {}
    for kind, name in enumerate(("alu", "shfl")):
        got = []
        for _ in range(3):
            cudalib.check(lib.rt_probe_latency(LATENCY_STEPS, kind, clocks.data_ptr(),
                                               sink.data_ptr(), cudalib.stream_handle()),
                          "probe_latency kernel")
            got.append(int(clocks.item()) / LATENCY_STEPS / (2 if name == "alu" else 1))
        out[name] = min(got)
    return out


def kernel_attrs(attrs_fn, ids: dict, what: str) -> dict:
    """{name: (registers per thread, local memory bytes per thread)} of the
    kernels `ids` ({name: id}) through a C entry point attrs_fn(id, &regs,
    &local)."""
    out = {}
    for name, i in ids.items():
        regs, local = ctypes.c_int(), ctypes.c_int()
        cudalib.check(attrs_fn(i, ctypes.byref(regs), ctypes.byref(local)), f"{what} attributes")
        out[name] = (regs.value, local.value)
    return out


def run_tile_case(call, on_card: bool, resources) -> tuple[dict, object]:
    """(timing, the output of call()) of a single-tile case: on the card
    TIMED_LAUNCHES timed calls after a warm-up (the last call's output is
    returned) with the kernel's resources(); on the CPU one call."""
    if not on_card:
        return {}, call()
    got = {}

    def timed():
        got["out"] = call()

    r = dict(ms=median(time_launches(timed)))
    r["num_regs"], r["local_bytes"] = resources()
    return r, got["out"]


def timing_suffix(r: dict) -> str:
    return f"; {r['ms']:.4f} ms, regs {r['num_regs']} local {r['local_bytes']} B" if "ms" in r \
        else ""


def device_arg(argv: list, what: str) -> str:
    """Pops `--device <dev>` from argv (default cuda); a CUDA run without a
    card stops here."""
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if device != "cpu":
        require_card(what)
    return device


def in_subprocesses(module: str, names, device: str, status=("PASS", "FAIL")) -> dict:
    """What the probe scripts do without arguments: each case `python -m
    module <name>` in a fresh process (a device fault then ends one case, not the
    run), printing "<status> <name>: <its last line>" (or its last error
    line). Returns {name: passed}."""
    res = {}
    for name in names:
        p = subprocess.run([sys.executable, "-u", "-m", module, name, "--device", device],
                           capture_output=True, text=True, timeout=600)
        line = (p.stdout.strip().splitlines() or ["<no output>"])[-1]
        err = (p.stderr.strip().splitlines() or [""])[-1]
        res[name] = p.returncode == 0
        print(f"{status[0] if res[name] else status[1]} {name}: "
              f"{line if res[name] else err[:160]}", flush=True)
    return res
