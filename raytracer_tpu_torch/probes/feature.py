"""The traversal kernel's constructs, one per stage, on the card: the port
of scripts/kernel_feature_probe.py (s1 :36 .. s7 :242; TPU calls :46, :72,
:103, :142, :186, :232). Stages s1-s6 are one kernel each on [8, 128]
tiles (csrc/probe_feature.cu) with the plain PyTorch version here
(`feature_plain`, the same operations in the same order), both held to the
script's own check of the stage:

  s1  six outputs x + i            allclose to x + i (x = arange)
  s2  a loop over 4 packets, x * 2 allclose to x * 2
  s3  a while loop of n trips (n read from a device int32[1], 7), acc + x
                                   allclose to 7
  s4  tasks 3..10 in shared memory, decremented inside a block-wide while
      loop on sum(task > 1)        out[0, 0] > 0 (it is 10, the trips)
  s5  a shared-memory stack, 16 pushes at dynamic indices, 8 pops
                                   finite (it is 776)
  s6  a row of the table and a record of it chosen by each chain's task,
      inside a 6-trip loop; tasks step through negative values, and the
      script's t % 16, t % 4 are floor mods
                                   finite
  s7  K4 (ops/cuda_traverse.trace_closest, csrc/trace_closest.cu) on the
      box-only reference scene, 1,024 rays of default_rng(3): the hit count

The entry point runs each stage in a fresh process, as the script does
without arguments, and prints "PASS <stage>: <the script's line>" per
stage and then the results; with a stage named it runs that stage in this
process.

    python -m raytracer_tpu_torch.probes.feature [s1..s7] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from raytracer_tpu_torch.probes import common
from raytracer_tpu_torch.utils import cudalib

CASES = ("s1", "s2", "s3", "s4", "s5", "s6")   # csrc/probe_feature.cu order
STAGES = CASES + ("s7",)
TILE = (8, 128)
S2_PACKETS, S3_TRIPS, S4_N0, S6_TRIPS = 4, 7, 8, 6
S7_RAYS, S7_SEED, S7_TMAX = 1024, 3, 3e38
LAUNCHES = {"probe_feature": 0}
PLAIN_CALLS = {"probe_feature": 0}
_IDS = {case: i for i, case in enumerate(CASES)}
S1, S2, S3, S6 = (_IDS[case] for case in ("s1", "s2", "s3", "s6"))


def _case_id(case: str) -> int:
    if case not in _IDS:
        raise ValueError(f"feature probe: unknown kernel stage {case!r} ({', '.join(CASES)})")
    return _IDS[case]


def inputs(case: str) -> tuple:
    """The stage's inputs as numpy arrays, as the script makes them."""
    _case_id(case)
    if case == "s1":
        return (np.arange(8 * 128, dtype=np.float32).reshape(TILE),)
    if case == "s2":
        return (np.arange(S2_PACKETS * 8 * 128, dtype=np.float32).reshape(S2_PACKETS, *TILE),)
    if case == "s3":
        return np.ones(TILE, np.float32), np.asarray([S3_TRIPS], np.int32)
    if case == "s6":
        return (np.arange(64 * 128, dtype=np.float32).reshape(64, 128),)
    return (np.ones(TILE, np.float32),)


def feature_plain(case: str, *ins: torch.Tensor) -> tuple:
    """Plain version: the stage's outputs on the inputs' device, in the
    kernel's order of operations (chains as a leading [8] axis)."""
    _case_id(case)
    PLAIN_CALLS["probe_feature"] += 1
    x = ins[0]
    if case == "s1":
        return tuple(x + float(i) for i in range(6))
    if case == "s2":
        return (torch.stack([x[p] * 2.0 for p in range(x.shape[0])]),)
    acc = torch.zeros(TILE, dtype=torch.float32, device=x.device)
    if case == "s3":
        i = int(ins[1][0])
        while i > 0:
            acc = acc + x
            i -= 1
        return (acc,)
    if case == "s4":
        task = torch.arange(8, dtype=torch.int32, device=x.device) + 3
        alive = S4_N0
        while alive > 0:
            t = task.clone()
            task = t - 1
            alive = int((t > 1).sum())
            acc = acc + x
        return (acc,)
    if case == "s5":
        stack, sp = [0] * 64, 0
        for i in range(16):
            stack[sp] = i
            stack[sp + (1 if i % 2 == 0 else 0)] = i * 10
            sp += 2 if i % 2 == 0 else 1
        for _ in range(8):
            v = stack[max(sp - 1, 0)]
            sp -= 1
            acc = acc + float(v)
        return (acc + 0.0 * x,)
    task = (5 * torch.arange(8, device=x.device)) % 17      # python / torch %: floor mod
    for _ in range(S6_TRIPS):
        row = x[torch.where(task >= 0, task % 16, torch.zeros_like(task))]     # [8, 128]
        rec = torch.gather(row.view(8, 4, 32), 1, (task % 4).view(8, 1, 1).expand(8, 1, 32))
        acc = acc + rec[:, 0].repeat(1, 4)
        task = task - 1
    return (acc,)


# The inputs the fast path takes, as cudalib.signature gives them: the
# script's x, s2's packets, s6's table and s3's trip count.
_X = (True, torch.float32, TILE, True)
_FAST = {S2: (True, torch.float32, (S2_PACKETS, *TILE), True),
         S6: (True, torch.float32, (64, 128), True)}
_N = (True, torch.int32, (1,), True)
_kernel = None   # rt_probe_feature, bound at the first launch


def _takes(case: str, ins: tuple) -> bool:
    """The wrapper's rules, with their errors, for inputs off its fast
    path: True where the kernel takes them (on the card), False where the
    plain version does (on the CPU); anything else raises."""
    _case_id(case)
    if len(ins) != (2 if case == "s3" else 1):
        raise ValueError(f"feature probe: {case} takes {'x, n' if case == 's3' else 'x'}")
    x = ins[0]
    dev = x.device.type if torch.is_tensor(x) else "cuda"
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"feature probe: unsupported device {x.device}")
    if case == "s2":
        cudalib.require_cuda("x", x, torch.float32, device_type=dev)
        if x.dim() != 3 or tuple(x.shape[1:]) != TILE:
            raise ValueError("feature probe: s2 takes x f32[packets, 8, 128]")
    elif case == "s6":
        cudalib.require_cuda("tab", x, torch.float32, device_type=dev)
        if x.dim() != 2 or x.shape[1] != 128 or x.shape[0] < 16:
            raise ValueError("feature probe: s6 takes a table f32[rows >= 16, 128]")
    else:
        cudalib.require_cuda("x", x, torch.float32, TILE, device_type=dev)
    if case == "s3":
        cudalib.require_cuda("n", ins[1], torch.int32, (1,), device_type=dev)
    return dev == "cuda"


def probe_feature(case: str, *ins: torch.Tensor) -> tuple:
    """The stage's kernel (csrc/probe_feature.cu) on CUDA tensors, its plain
    version on CPU tensors; a tuple of f32 outputs (six for s1, on the card
    views of one buffer, else one). The script's inputs on the card take
    the fast path: one signature comparison per input, the output from
    empty_like, the entry point bound once, the stream's raw handle."""
    global _kernel
    c = _IDS.get(case, -1)
    if c == S3:
        fast = len(ins) == 2 and cudalib.signature(ins[0]) == _X and \
            cudalib.signature(ins[1]) == _N
    else:
        fast = c >= 0 and len(ins) == 1 and cudalib.signature(ins[0]) == _FAST.get(c, _X)
    if not fast and not _takes(case, ins):
        return feature_plain(case, *ins)
    x = ins[0]
    xp = x.data_ptr()
    if xp & 15:
        cudalib.require_aligned("tab" if c == S6 else "x", xp)
    if _kernel is None:
        _kernel = cudalib.lib().rt_probe_feature
    if c == S1:   # its six outputs, consecutive tiles of one buffer
        out = x.new_empty((6, *TILE))
        code = _kernel(c, xp, None, 0, out.data_ptr(), cudalib.stream_handle())
    else:
        out = x.new_empty(TILE) if c == S6 else torch.empty_like(x)
        code = _kernel(c, xp, ins[1].data_ptr() if c == S3 else None,
                       x.shape[0] if c == S2 else 0, out.data_ptr(), cudalib.stream_handle())
    if code:
        cudalib.check(code, f"probe_feature kernel ({case})")
    LAUNCHES["probe_feature"] += 1
    return out.unbind(0) if c == S1 else (out,)


def check(case: str, outs, ins) -> tuple[bool, str]:
    """The script's own check of the stage and its line."""
    x = ins[0]
    if case == "s1":
        return all(np.allclose(o, x + i) for i, o in enumerate(outs)), "6 outputs + vmem_limit ok"
    o = outs[0]
    if case == "s2":
        return bool(np.allclose(o, x * 2.0)), "packet fori_loop ok"
    if case == "s3":
        return bool(np.allclose(o, float(S3_TRIPS))), "data-dependent while_loop ok"
    if case == "s4":
        return float(o[0, 0]) > 0, f"SMEM-in-while ok (iters={float(o[0, 0])})"
    ok = bool(np.isfinite(o).all())
    if case == "s5":
        return ok, f"dynamic SMEM store/load ok (val={float(o[0, 0])})"
    return ok, "dynamic fetch + select chain in while ok"


def work(case: str) -> dict:
    """Bytes (inputs read once, outputs written once) and fp32 operations of
    one launch, counted from csrc/probe_feature.cu per element of the
    output tile: s1 6 adds (one per output), s2 1 multiply per element of
    its 4 packets, s3 7 adds, s4 10 adds (its trips), s5 8 adds, a
    multiply and an add, s6 6 adds (the table's 6 rows read once each at
    most)."""
    n = TILE[0] * TILE[1]
    if case == "s1":
        return dict(bytes=4 * 7 * n, fp32_ops=6 * n, int32_ops=0)
    if case == "s2":
        return dict(bytes=4 * 2 * S2_PACKETS * n, fp32_ops=S2_PACKETS * n, int32_ops=0)
    n_in = {"s3": n + 1, "s6": 8 * 32 * S6_TRIPS}.get(case, n)
    ops = {"s3": S3_TRIPS, "s4": 10, "s5": 10, "s6": S6_TRIPS}[case] * n
    return dict(bytes=4 * (n_in + n), fp32_ops=ops, int32_ops=0)


def kernel_resources(cases=CASES) -> dict:
    """{stage: (registers per thread, local memory bytes per thread)}."""
    return common.kernel_attrs(cudalib.lib().rt_probe_feature_attrs,
                               {case: CASES.index(case) for case in cases}, "probe_feature")


def s7_inputs():
    """The box-only reference scene (default tree width) and the script's
    1,024 rays of default_rng(3): (scene, o f32[1024, 3], d f32[1024, 3])."""
    from raytracer_tpu_torch.scene.builder import reference_scene

    scene = reference_scene(with_bunny=False)
    rng = np.random.default_rng(S7_SEED)
    o = rng.uniform(-0.28, 0.28, (S7_RAYS, 3)).astype(np.float32)
    dd = rng.normal(size=(S7_RAYS, 3)).astype(np.float32)
    d = (dd / np.linalg.norm(dd, axis=1, keepdims=True)).astype(np.float32)
    return scene, torch.from_numpy(o), torch.from_numpy(d)


def s7(device="cuda", out=print) -> dict:
    """Stage s7: one trace_closest (K4 on CUDA tensors, sort=False as the
    script) of the script's rays on the box-only scene; the hit count."""
    from raytracer_tpu_torch.ops.cuda_traverse import trace_closest

    scene, o, d = s7_inputs()
    rc = trace_closest(o.to(device), d.to(device), scene.bvh4.to(device), S7_TMAX, sort=False)
    hit = int(rc["hit"].sum())
    out(f"real kernel tiny scene ok (hit={hit}/{S7_RAYS})")
    return dict(ok=True, hit=hit)


def run_case(case: str, device="cuda", out=print) -> dict:
    """One stage as the script runs it: s1-s6 the kernel (on the card 10
    timed launches after a warm-up, the last one's outputs checked) under
    the script's check; s7 through `s7`."""
    if case == "s7":
        return s7(device, out)
    ins_np = inputs(case)
    ins = tuple(torch.from_numpy(a).to(device) for a in ins_np)
    r, got = common.run_tile_case(lambda: probe_feature(case, *ins), ins[0].is_cuda,
                                  lambda: kernel_resources((case,))[case])
    r["ok"], line = check(case, [g.cpu().numpy() for g in got], ins_np)
    r["value"] = float(got[0].reshape(-1)[0])
    out(line + common.timing_suffix(r) if r["ok"] else f"{case}: the script's check fails")
    return r


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = common.device_arg(argv, "feature")
    if argv:
        return 0 if run_case(argv[0], device)["ok"] else 1
    res = common.in_subprocesses(__spec__.name, STAGES, device)
    print({k: "PASS" if v else "FAIL" for k, v in res.items()}, flush=True)
    return 0 if all(res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
