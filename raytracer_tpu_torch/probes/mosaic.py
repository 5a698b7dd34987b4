"""The Mosaic primitives of the sub-warp kernel, one at a time, on the
card: the port of scripts/mosaic_probe.py (run :21, TPU call :22; its
kernels :44-145). Each case is one kernel on an [8, 128] tile
(csrc/probe_mosaic.cu) with its plain PyTorch version here (`mosaic_plain`,
the same operations in the same order), both held to the script's NumPy
expectation at rtol / atol 1e-5, as the script holds its kernels:

  colbcast      x * x[:, 3:4]
  lanesum       x + x.sum(1, keepdims)
  packsum       per row: lo * 1000 + hi of sum((x > 0) + ((x < -0.5) << 16))
  concat        x[0] replicated to 8 rows, times x[0, 5]
  bitcast       the int32 bits of lanes 25 and 26 of each row of a tile of
                integers below 2^20 viewed as float32 (denormals)
  extract_smem  x[s, 7] > 0 through shared memory
  dynload       tab[idx[s, 0]] for each row s, the index through shared
                memory

Inputs are the script's: one default_rng(0) draws x f32[8, 128], the
integer tile, tab f32[64, 128] and idx in [0, 64), in that order. The
script runs every case in one process; so does the entry point, which
prints the script's line per case and, on the card, the kernel's median
time of 10 launches and its registers.

    python -m raytracer_tpu_torch.probes.mosaic [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from raytracer_tpu_torch.probes import common
from raytracer_tpu_torch.utils import cudalib

CASES = ("colbcast", "lanesum", "packsum", "concat", "bitcast", "extract_smem", "dynload")
NAMES = {"colbcast": "colslice (8,1) broadcast", "lanesum": "lane-sum keepdims",
         "packsum": "packed sum + extract[s,0]", "concat": "concat-replicate row",
         "bitcast": "bitcast odd-offset slice", "extract_smem": "extract[s,7] via SMEM",
         "dynload": "8x dynamic row loads"}
INT_OUT = ("packsum", "bitcast", "extract_smem")
TILE = (8, 128)
RTOL = ATOL = 1e-5
LAUNCHES = {"probe_mosaic": 0}
PLAIN_CALLS = {"probe_mosaic": 0}
_IDS = {case: i for i, case in enumerate(CASES)}
DYNLOAD = _IDS["dynload"]
_INT_IDS = frozenset(_IDS[case] for case in INT_OUT)


def _case_id(case: str) -> int:
    if case not in _IDS:
        raise ValueError(f"mosaic probe: unknown case {case!r} ({', '.join(CASES)})")
    return _IDS[case]


def script_inputs() -> dict:
    """The script's arrays, drawn from one default_rng(0) in its order."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=TILE).astype(np.float32)
    iv = rng.integers(0, 1 << 20, size=TILE).astype(np.int32)
    tab = rng.normal(size=(64, 128)).astype(np.float32)
    idx = rng.integers(0, 64, size=TILE).astype(np.int32)
    return dict(x=x, iv=iv, tab=tab, idx=idx)


def inputs(case: str) -> tuple:
    """The case's inputs as numpy arrays: (x,), (the integer tile viewed
    as float32,) or (tab, idx)."""
    _case_id(case)
    a = script_inputs()
    if case == "bitcast":
        return (a["iv"].view(np.float32),)
    if case == "dynload":
        return a["tab"], a["idx"]
    return (a["x"],)


def expected(case: str) -> np.ndarray:
    """The script's NumPy expectation of the case."""
    a = script_inputs()
    x = a["x"]
    if case == "colbcast":
        return x * x[:, 3:4]
    if case == "lanesum":
        return x + x.sum(axis=1, keepdims=True)
    if case == "packsum":
        b, c = (x > 0).astype(np.int32), (x < -0.5).astype(np.int32)
        return (b.sum(1) * 1000 + c.sum(1))[:, None] * np.ones((1, 128), np.int32)
    if case == "concat":
        return np.broadcast_to(x[0:1], TILE) * x[0, 5]
    if case == "bitcast":
        return np.broadcast_to(a["iv"][:, 25:26], TILE)
    if case == "extract_smem":
        return np.broadcast_to((x[:, 7:8] > 0).astype(np.int32), TILE)
    _case_id(case)
    return a["tab"][a["idx"][:, 0]]


def mosaic_plain(case: str, *ins: torch.Tensor) -> torch.Tensor:
    """Plain version: the case's [8, 128] output on the inputs' device, in
    the kernel's order of operations."""
    _case_id(case)
    PLAIN_CALLS["probe_mosaic"] += 1
    x = ins[0]
    if case == "colbcast":
        return x * x[:, 3:4]
    if case == "lanesum":
        # The kernel's order: thread l adds its lanes 4l..4l+3 in order, then
        # the butterfly adds partner l ^ m for m = 16, 8, 4, 2, 1.
        v = x.view(8, 32, 4)
        t = ((v[..., 0] + v[..., 1]) + v[..., 2]) + v[..., 3]
        lanes = torch.arange(32, device=x.device)
        for m in (16, 8, 4, 2, 1):
            t = t + t[:, lanes ^ m]
        return (v + t[..., None]).view(TILE)
    if case == "packsum":
        pa = ((x > 0).to(torch.int32) + ((x < -0.5).to(torch.int32) << 16)).sum(
            1, keepdim=True, dtype=torch.int32)
        return ((pa & 0xFFFF) * 1000 + (pa >> 16)).expand(TILE).contiguous()
    if case == "concat":
        return x[0:1].expand(TILE) * x[0, 5]
    if case == "bitcast":
        ids = x.view(torch.int32)[:, 25:27]
        return (ids[:, 0:1] + 0 * ids[:, 1:2]).expand(TILE).contiguous()
    if case == "extract_smem":
        return (x[:, 7:8] > 0).to(torch.int32).expand(TILE).contiguous()
    tab, idx = ins
    return tab[idx[:, 0].clamp(0, tab.shape[0] - 1).long()]


# The inputs the fast path takes, as cudalib.signature gives them: x (or
# the integer tile as float32), the script's table and index tile.
_X = (True, torch.float32, TILE, True)
_TAB = (True, torch.float32, (64, 128), True)
_IDX = (True, torch.int32, TILE, True)
_kernel = None   # rt_probe_mosaic, bound at the first launch


def _takes(case: str, ins: tuple) -> bool:
    """The wrapper's rules, with their errors, for inputs off its fast
    path: True where the kernel takes them (on the card), False where the
    plain version does (on the CPU); anything else raises."""
    _case_id(case)
    if len(ins) != (2 if case == "dynload" else 1):
        raise ValueError(f"mosaic probe: {case} takes {'tab, idx' if case == 'dynload' else 'x'}")
    dev = ins[0].device.type if torch.is_tensor(ins[0]) else "cuda"
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"mosaic probe: unsupported device {ins[0].device}")
    if case == "dynload":
        tab, idx = ins
        cudalib.require_cuda("tab", tab, torch.float32, device_type=dev)
        if tab.dim() != 2 or tab.shape[1] != 128 or tab.shape[0] < 1:
            raise ValueError("mosaic probe: tab must be f32[rows >= 1, 128]")
        cudalib.require_cuda("idx", idx, torch.int32, TILE, device_type=dev)
    else:
        cudalib.require_cuda("x", ins[0], torch.float32, TILE, device_type=dev)
    return dev == "cuda"


def probe_mosaic(case: str, *ins: torch.Tensor) -> torch.Tensor:
    """The case's kernel (csrc/probe_mosaic.cu) on CUDA tensors, its plain
    version on CPU tensors. The script's inputs on the card take the fast
    path: one signature comparison per input, the output from empty_like,
    the entry point bound once, the stream's raw handle."""
    global _kernel
    c = _IDS.get(case, -1)
    if c == DYNLOAD:
        fast = (len(ins) == 2 and cudalib.signature(ins[0]) == _TAB
                and cudalib.signature(ins[1]) == _IDX)
    else:
        fast = c >= 0 and len(ins) == 1 and cudalib.signature(ins[0]) == _X
    if not fast and not _takes(case, ins):
        return mosaic_plain(case, *ins)
    x = ins[0]
    xp = x.data_ptr()
    if xp & 15:
        cudalib.require_aligned("tab" if c == DYNLOAD else "x", xp)
    if _kernel is None:
        _kernel = cudalib.lib().rt_probe_mosaic
    if c == DYNLOAD:
        out = x.new_empty(TILE)
        code = _kernel(c, xp, ins[1].data_ptr(), x.shape[0], out.data_ptr(),
                       cudalib.stream_handle())
    else:
        out = torch.empty_like(x, dtype=torch.int32) if c in _INT_IDS else torch.empty_like(x)
        code = _kernel(c, xp, None, 1, out.data_ptr(), cudalib.stream_handle())
    if code:
        cudalib.check(code, f"probe_mosaic kernel ({case})")
    LAUNCHES["probe_mosaic"] += 1
    return out


def check(case: str, got: np.ndarray) -> tuple[bool, float]:
    """The script's rule: allclose to its expectation at rtol / atol 1e-5;
    (ok, the largest |difference|)."""
    want = expected(case)
    if got.shape != want.shape:
        return False, float("inf")
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    return bool(np.allclose(got, want, rtol=RTOL, atol=ATOL)), err


def work(case: str) -> dict:
    """Bytes (inputs read once, the output written once) and operations
    of one tile, counted from csrc/probe_mosaic.cu per element: colbcast
    and concat 1 fp32 multiply; lanesum 2 fp32 adds (the row's sum, then
    the add to x); packsum 2 fp32 compares and 3 int32 (shift, two adds);
    bitcast 2 int32 (the multiply by 0 and the add); extract_smem 1 fp32
    compare per row; dynload none."""
    n = TILE[0] * TILE[1]
    fp, it = {"colbcast": (n, 0), "lanesum": (2 * n, 0), "packsum": (2 * n, 3 * n),
              "concat": (n, 0), "bitcast": (0, 2 * n), "extract_smem": (8, 0),
              "dynload": (0, 0)}[case]
    n_in = n + (n if case == "dynload" else 0)   # dynload: 8 table rows + idx
    return dict(bytes=4 * (n_in + n), fp32_ops=fp, int32_ops=it)


def kernel_resources(cases=CASES) -> dict:
    """{case: (registers per thread, local memory bytes per thread)}."""
    return common.kernel_attrs(cudalib.lib().rt_probe_mosaic_attrs,
                               {case: CASES.index(case) for case in cases}, "probe_mosaic")


def run_case(case: str, device="cuda", out=print) -> dict:
    """One case as the script's run() runs it: the kernel (on the card 10
    timed launches after a warm-up, the last one's output checked) against
    the script's expectation. chip_smoke.py and the card tests also hold
    the kernel to its plain version on the card."""
    ins = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in inputs(case))
    r, got = common.run_tile_case(lambda: probe_mosaic(case, *ins), ins[0].is_cuda,
                                  lambda: kernel_resources((case,))[case])
    r["ok"], r["max_abs_err_expected"] = check(case, got.cpu().numpy())
    line = f"{NAMES[case]:28s}: {'OK' if r['ok'] else 'FAIL'}"
    if not r["ok"]:
        line += f"  (max|diff| {r['max_abs_err_expected']})"
    out(line + common.timing_suffix(r))
    return r


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = common.device_arg(argv, "mosaic")
    return 0 if all([run_case(case, device)["ok"] for case in CASES]) else 1


if __name__ == "__main__":
    sys.exit(main())
