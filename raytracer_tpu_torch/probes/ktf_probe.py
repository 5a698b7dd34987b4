"""The path loop's random-number operations inside a kernel, on the card:
the port of scripts/ktf_kernel_probe.py (run_case :21; TPU calls :34,
:141). Each case is one kernel on an [8, 128] tile (csrc/probe_ktf.cu,
built from csrc/ktf.cuh, the code K3 inlines), its plain version is
utils/ktf.py's, and both are held to the script's expectations:

  intops        a + b, a ^ b, rotl13(a), logical a >>> 9: bitwise against
                the NumPy uint32 result
  threefry      threefry2x32 under (0x1234ABCD - 2^31, 77): bitwise
                against utils/ktf.py on the host
  u01           bitwise against utils/ktf.py on the host
  unitvec       the unit vector of two u01 draws (sqrt, cos, sin) against
                the script's NumPy formula, atol 1e-5 (x, y) and 1e-6 (z)
  sampler_tile  the sampler of key 9 on the tile's pixels, sample 5,
                bounce 2: rr_uniform bitwise, unit_vector_parts(SCATTER) at
                the atol of unitvec, against utils/ktf.py on the host

Inputs are the script's: default_rng(7), int32 words drawn over the whole
range (pixels masked to 22 bits). The kernel is held to its plain version
on the same device bit for bit, the unit vectors too (both take the card's
IEEE sqrtf, cosf and sinf in the same order). On the card `probe_ktf`
takes the launch path of probes/mosaic.py: one signature comparison per
input, the key words computed at import, the entry point bound once, one
[n_out, 8, 128] output returned as its rows, the stream's raw handle.
The entry point runs each case in a subprocess, as the script does, so
that a device fault ends one case and not the run; a case that fails a
check exits 1.

    python -m raytracer_tpu_torch.probes.ktf_probe [case] [--device cpu]
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from raytracer_tpu_torch.probes import common
from raytracer_tpu_torch.utils import cudalib, ktf

CASES = ("intops", "threefry", "u01", "unitvec", "sampler_tile")  # csrc/probe_ktf.cu order
TILE = (8, 128)
K0, K1 = 0x1234ABCD - 2**31, 77          # the threefry case's key words
KEY, SAMPLE, BOUNCE = 9, 5, 2            # the sampler_tile case's draw context
PIXEL_MASK = 0x3FFFFF
ATOL_XY, ATOL_Z = 1e-5, 1e-6
INT_OUT = ("intops", "threefry")         # cases with int32 outputs
N_OUT = {"intops": 4, "threefry": 2, "u01": 1, "unitvec": 3, "sampler_tile": 4}
LAUNCHES = {"probe_ktf": 0}
PLAIN_CALLS = {"probe_ktf": 0}


def _case_id(case: str) -> int:
    if case not in CASES:
        raise ValueError(f"ktf probe: unknown case {case!r} ({', '.join(CASES)})")
    return CASES.index(case)


def inputs(case: str) -> tuple:
    """The script's inputs of `case` as int32 numpy arrays: each case draws
    from a fresh default_rng(7), as each runs in its own process there."""
    _case_id(case)
    rng = np.random.default_rng(7)

    def i32(shape):
        return rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)

    if case in ("intops", "threefry"):
        return i32(TILE), i32(TILE)
    if case == "u01":
        return (i32(TILE),)
    if case == "unitvec":
        bits = i32((2, *TILE))
        return bits[0], bits[1]
    return (i32(TILE) & PIXEL_MASK,)


def ktf_plain(case: str, *ins: torch.Tensor) -> tuple:
    """Plain version: the case's outputs through utils/ktf.py on the
    inputs' device (int32 or float32 [8, 128] tensors)."""
    _case_id(case)
    PLAIN_CALLS["probe_ktf"] += 1
    if case == "intops":
        a, b = ins
        return a + b, a ^ b, ktf._rotl(a, 13), ktf._srl(a, 9)
    if case == "threefry":
        return ktf.threefry2x32(K0, K1, *ins)
    if case == "u01":
        return (ktf.u01(ins[0]),)
    if case == "unitvec":
        return ktf.unit_vector_parts(ktf.u01(ins[0]), ktf.u01(ins[1]))
    k0, k1 = ktf.key_words(KEY)
    dev = ins[0].device
    smp = ktf.KtfSampler(k0, k1, ins[0], torch.tensor(SAMPLE, dtype=torch.int32, device=dev),
                         torch.tensor(BOUNCE, dtype=torch.int32, device=dev))
    return (smp.rr_uniform(), *smp.unit_vector_parts(ktf.SCATTER))


# The inputs the fast path takes, as cudalib.signature gives them; each
# case's id, input count, output dtype and key words (csrc/probe_ktf.cu).
_IN = (True, torch.int32, TILE, True)
_IDS = {case: i for i, case in enumerate(CASES)}
_N_IN = {case: 1 if case in ("u01", "sampler_tile") else 2 for case in CASES}
_DTYPE = {case: torch.int32 if case in INT_OUT else torch.float32 for case in CASES}
_KEYS = {case: tuple(k & 0xFFFFFFFF for k in ((K0, K1) if case == "threefry"
                                               else ktf.key_words(KEY))) for case in CASES}
_kernel = None   # rt_probe_ktf, bound at the first launch


def _takes(case: str, ins: tuple) -> bool:
    """The wrapper's rules, with their errors, for inputs off its fast
    path: True where the kernel takes them (on the card), False where the
    plain version does (on the CPU); anything else raises."""
    _case_id(case)
    if len(ins) != _N_IN[case]:
        raise ValueError(f"ktf probe: {case} takes {_N_IN[case]} int32 [8, 128] inputs, "
                         f"got {len(ins)}")
    dev = ins[0].device.type if torch.is_tensor(ins[0]) else "cuda"
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"ktf probe: unsupported device {ins[0].device}")
    for j, t in enumerate(ins):
        cudalib.require_cuda(f"input {j}", t, torch.int32, TILE, device_type=dev)
    return dev == "cuda"


def probe_ktf(case: str, *ins: torch.Tensor) -> tuple:
    """The case's kernel (csrc/probe_ktf.cu) on CUDA tensors, its plain
    version on CPU tensors: its outputs, [8, 128] each (on the card the rows
    of one [n_out, 8, 128] tensor)."""
    global _kernel
    n = _N_IN.get(case, -1)
    fast = (len(ins) == n and cudalib.signature(ins[0]) == _IN
            and (n == 1 or cudalib.signature(ins[1]) == _IN))
    if not fast and not _takes(case, ins):
        return ktf_plain(case, *ins)
    a = ins[0].data_ptr()
    b = ins[1].data_ptr() if n == 2 else None
    if (a | (b or 0)) & 15:
        cudalib.require_aligned("input 0", a)
        cudalib.require_aligned("input 1", b)
    if _kernel is None:
        _kernel = cudalib.lib().rt_probe_ktf
    out = ins[0].new_empty((N_OUT[case], *TILE), dtype=_DTYPE[case])
    code = _kernel(_IDS[case], a, b, *_KEYS[case], out.data_ptr(), cudalib.stream_handle())
    if code:
        cudalib.check(code, f"probe_ktf kernel ({case})")
    LAUNCHES["probe_ktf"] += 1
    return out.unbind(0)


def expected(case: str, *ins: np.ndarray) -> tuple:
    """The script's expectation on the host: NumPy's uint32 arithmetic
    (intops) and float formula (unitvec), utils/ktf.py on the CPU for the
    others (the script's host ktf)."""
    if case == "intops":
        ua, ub = (x.view(np.uint32) for x in ins)
        return (ua + ub).view(np.int32), (ua ^ ub).view(np.int32), \
            ((ua << 13) | (ua >> 19)).view(np.int32), (ua >> 9).view(np.int32)
    if case == "unitvec":
        u1, u2 = (ktf.u01(torch.from_numpy(x)).numpy() for x in ins)
        z = 1.0 - 2.0 * u1
        r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
        return r * np.cos(2 * np.pi * u2), r * np.sin(2 * np.pi * u2), z
    a = [torch.from_numpy(x) for x in ins]
    if case == "threefry":
        return tuple(t.numpy() for t in ktf.threefry2x32(K0, K1, *a))
    if case == "u01":
        return (ktf.u01(a[0]).numpy(),)
    smp = ktf.KtfSampler(*ktf.key_words(KEY), a[0], torch.tensor(SAMPLE, dtype=torch.int32),
                         torch.tensor(BOUNCE, dtype=torch.int32))
    return tuple(t.numpy() for t in (smp.rr_uniform(), *smp.unit_vector_parts(ktf.SCATTER)))


def atols(case: str) -> tuple:
    """Per output: None for bitwise, else the absolute tolerance."""
    if case == "unitvec":
        return ATOL_XY, ATOL_XY, ATOL_Z
    if case == "sampler_tile":
        return None, ATOL_XY, ATOL_XY, ATOL_Z
    return (None,) * N_OUT[case]


def agrees(case: str, got, want) -> tuple[bool, float]:
    """(every output within its rule, the largest |difference|)."""
    ok, err = True, 0.0
    for g, w, atol in zip(got, want, atols(case)):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape:
            return False, float("inf")
        diff = np.abs(g.astype(np.float64) - w.astype(np.float64))
        err = max(err, float(diff.max()))
        ok &= bool((g == w).all()) if atol is None else bool((diff <= atol).all())
    return ok, err


def work(case: str) -> dict:
    """Bytes (the inputs read once, the outputs written once) and int32 /
    fp32 operations of one tile, counted from csrc/probe_ktf.cu and
    ktf.cuh per element: intops 6 (add, xor, rotl as two shifts and an
    or, shr); Threefry 72 (chip_smoke.THREEFRY_OPS); u01 a shift and two
    fp32 (convert, scale); the unit vector 15 fp32 (z 2, r 4, phi 1, cos,
    sin, two products, two u01) and 2 int32 shifts; the sampler two
    Threefry blocks with their counter words (2 x 4) and the RR u01."""
    n = TILE[0] * TILE[1]
    int_ops, fp_ops = {"intops": (6, 0), "threefry": (72, 0), "u01": (1, 2), "unitvec": (2, 15),
                       "sampler_tile": (2 * 72 + 8 + 3, 17)}[case]
    n_in = 1 if case in ("u01", "sampler_tile") else 2
    return dict(bytes=4 * n * (n_in + N_OUT[case]), int32_ops=int_ops * n, fp32_ops=fp_ops * n)


def kernel_resources(cases=CASES) -> dict:
    """{case: (registers per thread, local memory bytes per thread)}."""
    return common.kernel_attrs(cudalib.lib().rt_probe_ktf_attrs,
                               {case: CASES.index(case) for case in cases}, "probe_ktf")


def run_case(case: str, device="cuda", out=print) -> dict:
    """One case as the script's run_case runs it: the kernel (on the card
    10 timed launches after a warm-up, the last one's outputs checked)
    against the script's expectation on the host. chip_smoke.py and the
    card tests also hold the kernel to its plain version on the card."""
    device = torch.device(device)
    ins_np = inputs(case)
    ins = tuple(torch.from_numpy(x).to(device) for x in ins_np)
    r = {}
    if ins[0].is_cuda:
        got = {}

        def call():
            got["out"] = probe_ktf(case, *ins)

        r["ms"] = common.median(common.time_launches(call))
        r["num_regs"], r["local_bytes"] = kernel_resources((case,))[case]
        outs = got["out"]
    else:
        outs = probe_ktf(case, *ins)
    r["ok"], r["max_abs_err_expected"] = agrees(case, [t.cpu().numpy() for t in outs],
                                                expected(case, *ins_np))
    rules = ", ".join("bitwise" if a is None else f"atol {a:g}" for a in atols(case))
    line = (f"{case}: vs the script's expectation {'OK' if r['ok'] else 'FAIL'} ({rules}; max "
            f"|diff| {r['max_abs_err_expected']:.3g})")
    if "ms" in r:
        line += f"; {r['ms']:.4f} ms, regs {r['num_regs']} local {r['local_bytes']} B"
    out(line)
    return r


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = common.device_arg(argv, "ktf_probe")
    if argv:
        return 0 if run_case(argv[0], device)["ok"] else 1
    fails = []
    for case in CASES:
        print(f"case {case}:", flush=True)
        r = subprocess.run([sys.executable, "-u", "-m", __spec__.name, case, "--device", device],
                           timeout=600)
        if r.returncode != 0:
            fails.append(case)
            print(f"  -> subprocess rc={r.returncode} (FAIL/crash)", flush=True)
    print(f"{len(CASES) - len(fails)}/{len(CASES)} cases OK; failures: {fails}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
