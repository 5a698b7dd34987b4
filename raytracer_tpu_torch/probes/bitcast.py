"""Id bitcasts and int broadcast-selects on the v5 tables, on the card:
the port of scripts/bitcast_probe.py (p1 :48, p2 :83, p3 :116, p4 :149;
TPU calls :69, :101, :136, :173). Each probe is one kernel on an [8, 128]
tile (csrc/probe_bitcast.cu) with its plain PyTorch version here
(`bitcast_plain`, the same bits through Tensor.view(torch.int32)):

  p1  the bits of the 8 records' prim and material ids of the first
      brute-force row, replicated to 8 chains
  p2  best = where(x > k * 0.5, 100 + k, best), k = 0..3 (x of
      default_rng(0))
  p3  the bits of the child codes of nodes 0-7, each read through its
      row's record select
  p4  p1's ids selected into best / mat by lane % 8

The tables are the reference scene's, built 4-wide (probes/v5_tables.py,
the port's copy of the TPU kernel's _pack_tables). Each probe's verdict
is the script's: the bits against the scene's ids (p1, p4: brute_prim and
brute_mat; p3: the children of nodes 0-7) or against NumPy's select (p2).
The tables carry their ids float-encoded (prim 400 is 400.0f), so the
bits of p1, p3 and p4 are float bit patterns (400.0f is 1137180672, the
child code 1.0f is 1065353216) and those three print BAD, as the script
does in interpret mode; p2 prints OK. Kernel and plain version are held
to each other bit for bit, and each verdict to the plain version's.

The entry point runs each probe in a fresh process, as the script does
without arguments ("PASS <probe>: <the script's line>", or CRASH); with a
probe named it runs that one in this process.

    python -m raytracer_tpu_torch.probes.bitcast [p1|p2|p3|p4] [--device cpu]
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from raytracer_tpu_torch.probes import common
from raytracer_tpu_torch.probes.v5_tables import P_LANE, P_SUB, pack_tables
from raytracer_tpu_torch.utils import cudalib

CASES = ("p1", "p2", "p3", "p4")   # csrc/probe_bitcast.cu order
P1, P2, P3, P4 = range(len(CASES))
_IDS = {case: i for i, case in enumerate(CASES)}
TILE = (P_SUB, P_LANE)
LAUNCHES = {"probe_bitcast": 0}
PLAIN_CALLS = {"probe_bitcast": 0}


@dataclass
class Tables:
    """The v5 tables of a 4-wide tree and what the verdicts compare with."""

    node: torch.Tensor          # f32[rows, 128]
    tri: torch.Tensor           # f32[rows, 128]
    r0: int                     # the first brute-force row
    brute_prim: np.ndarray      # i32[8]: the first brute row's prim ids
    brute_mat: np.ndarray       # i32[8]
    children: np.ndarray        # i32[8, 4]: nodes 0-7's child codes


def tables_of(bvh4) -> Tables:
    """Tables of a 4-wide Bvh4 with a brute-force set (pack_tables)."""
    node, tri, _, n_brute = pack_tables(bvh4, bvh4.face_mat)
    if bvh4.brute_tri is None or n_brute < 1 or node.shape[0] < 2:
        raise ValueError("bitcast probe: needs a brute-force row and at least 8 nodes")
    return Tables(node, tri, tri.shape[0] - 1 - n_brute,
                  np.asarray(bvh4.brute_prim[:8], np.int32),
                  np.asarray(bvh4.brute_mat[:8], np.int32),
                  np.asarray(bvh4.children[:8], np.int32))


def reference_tables() -> Tables:
    """The script's tables: the reference scene built 4-wide."""
    from raytracer_tpu_torch.scene.builder import reference_scene, tree_width

    with tree_width(4):
        return tables_of(reference_scene().bvh4)


def p2_input() -> np.ndarray:
    return np.random.default_rng(0).normal(size=TILE).astype(np.float32)


def _case_id(case: str) -> int:
    if case not in _IDS:
        raise ValueError(f"bitcast probe: unknown probe {case!r} ({', '.join(CASES)})")
    return _IDS[case]


def case_input(case: str, tabs: Tables, device) -> tuple[torch.Tensor, int]:
    """(the table or tile the case reads, its row r0) on `device`."""
    _case_id(case)
    if case == "p2":
        return torch.from_numpy(p2_input()).to(device), 0
    return (tabs.node if case == "p3" else tabs.tri).to(device).contiguous(), tabs.r0


def bitcast_plain(case: str, tab: torch.Tensor, r0: int) -> tuple:
    """Plain version: the case's i32[8, 128] outputs (p4: best, mat) on the
    input's device."""
    _case_id(case)
    PLAIN_CALLS["probe_bitcast"] += 1
    i32 = dict(dtype=torch.int32, device=tab.device)
    cols = torch.arange(P_LANE, device=tab.device).expand(TILE)
    if case == "p2":
        best = torch.full(TILE, -1, **i32)
        for k in range(4):
            best = torch.where(tab > float(k) * 0.5, torch.full_like(best, 100 + k), best)
        return (best,)
    if case == "p3":
        nodes = torch.arange(P_SUB, device=tab.device)
        rec = tab[nodes // 4].view(P_SUB, 4, 32)[nodes, nodes % 4]        # [8, 32]
        ch = rec[:, 24:28].contiguous().view(torch.int32)                  # [8, 4]
        acc = torch.zeros(TILE, **i32)
        for k in range(4):
            acc = torch.where(cols == k, ch[:, k:k + 1], acc)
        return (acc,)
    ids = tab[r0].view(8, 16)[:, 9:11].contiguous().view(torch.int32)     # [8 records, 2]
    if case == "p1":
        acc = torch.zeros(TILE, **i32)
        for k in range(8):
            acc = torch.where(cols == 2 * k, ids[k, 0], acc)
            acc = torch.where(cols == 2 * k + 1, ids[k, 1], acc)
        return (acc,)
    best, mat = torch.full(TILE, -1, **i32), torch.zeros(TILE, **i32)
    for k in range(8):
        ok = (cols % 8) == k
        best = torch.where(ok, ids[k, 0], best)
        mat = torch.where(ok, ids[k, 1], mat)
    return best, mat


# The fast path's inputs: p2's x as cudalib.signature gives it; a table's
# (on a card, dtype, shape[1:], contiguous), then its rows against the
# last row the case reads.
_X = (True, torch.float32, TILE, True)
_TAB = (True, torch.float32, (P_LANE,), True)
_kernel = None   # rt_probe_bitcast, bound at the first launch


def _takes(case: str, tab, r0: int) -> bool:
    """The wrapper's rules, with their errors, for inputs off its fast
    path: True where the kernel takes them (on the card), False where the
    plain version does (on the CPU); anything else raises."""
    c = _case_id(case)
    dev = tab.device.type if torch.is_tensor(tab) else "cuda"
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"bitcast probe: unsupported device {tab.device}")
    if c == P2:
        cudalib.require_cuda("x", tab, torch.float32, TILE, device_type=dev)
    else:
        cudalib.require_cuda("table", tab, torch.float32, device_type=dev)
        rows = 2 if c == P3 else r0 + 1
        if tab.dim() != 2 or tab.shape[1] != P_LANE or tab.shape[0] < rows or r0 < 0:
            raise ValueError(f"bitcast probe: {case} reads rows up to {rows - 1} of a "
                             f"f32[rows, 128] table, got {tuple(tab.shape)}")
    return dev == "cuda"


def probe_bitcast(case: str, tab: torch.Tensor, r0: int) -> tuple:
    """The case's kernel (csrc/probe_bitcast.cu) on a CUDA tensor, its plain
    version on a CPU tensor: its i32[8, 128] outputs (p4: best, mat; on the
    card the rows of one [2, 8, 128] tensor, which took less host time than
    two allocations). The inputs it takes on the card take the fast path:
    one comparison for the input's kind and one for its rows, the output
    from new_empty, the entry point bound once, the stream's raw handle."""
    global _kernel
    c = _IDS.get(case, -1)
    if c == P2:
        fast = cudalib.signature(tab) == _X
    else:
        fast = (c >= 0 and isinstance(tab, torch.Tensor)
                and (tab.is_cuda, tab.dtype, tab.shape[1:], tab.is_contiguous()) == _TAB
                and 0 <= r0 and (1 if c == P3 else r0) < tab.shape[0])
    if not fast and not _takes(case, tab, r0):
        return bitcast_plain(case, tab, r0)
    tp = tab.data_ptr()
    if tp & 15:
        cudalib.require_aligned("x" if c == P2 else "table", tp)
    if _kernel is None:
        _kernel = cudalib.lib().rt_probe_bitcast
    if c == P4:   # best and mat, the rows of one buffer
        out = tab.new_empty((2, *TILE), dtype=torch.int32)
        op = out.data_ptr()
        code = _kernel(c, tp, r0, op, op + 4 * P_SUB * P_LANE, cudalib.stream_handle())
        outs = out.unbind(0)
    else:
        out = tab.new_empty(TILE, dtype=torch.int32)
        code = _kernel(c, tp, r0, out.data_ptr(), None, cudalib.stream_handle())
        outs = (out,)
    if code:
        cudalib.check(code, f"probe_bitcast kernel ({case})")
    LAUNCHES["probe_bitcast"] += 1
    return outs


def verdict(case: str, outs, tabs: Tables) -> tuple[bool, str]:
    """The script's verdict on the outputs (numpy) and its line."""
    if case == "p1":
        got = outs[0][0, :16]
        want = np.stack([tabs.brute_prim, tabs.brute_mat], axis=1).reshape(-1)
        ok = bool((got == want).all())
        return ok, f"{'OK' if ok else 'BAD'} got={got.tolist()} want={want.tolist()}"
    if case == "p2":
        got, x = outs[0], p2_input()
        want = np.full(TILE, -1, np.int32)
        for k in range(4):
            want = np.where(x > k * 0.5, 100 + k, want)
        ok = bool((got == want).all())
        return ok, (f"{'OK' if ok else 'BAD'} diffs={int((got != want).sum())} "
                    f"sample got={got[0, :6].tolist()} want={want[0, :6].tolist()}")
    if case == "p3":
        got, want = outs[0][:, :4], tabs.children
        ok = bool((got == want).all())
        return ok, (f"{'OK' if ok else 'BAD'} got0={got[0].tolist()} "
                    f"want0={want[0].tolist()} diffs={int((got != want).sum())}/32")
    got_b, got_m = outs[0][0, :8], outs[1][0, :8]
    ok = bool((got_b == tabs.brute_prim).all() and (got_m == tabs.brute_mat).all())
    return ok, (f"{'OK' if ok else 'BAD'} got_prim={got_b.tolist()} "
                f"want_prim={tabs.brute_prim.tolist()} got_mat={got_m.tolist()} "
                f"want_mat={tabs.brute_mat.tolist()}")


def work(case: str) -> dict:
    """Bytes (what the case reads once, its outputs written once) and
    operations of one tile, counted from csrc/probe_bitcast.cu: p1 and p4
    read the two ids of 8 records (64 bytes), p3 the four child codes of 8
    node records (128 bytes), p2 its tile; p2 takes 4 fp32 compares and 4
    selects per element, and p1, p3 and p4 only move bits (loads, shuffles,
    stores), no operation on them."""
    n = TILE[0] * TILE[1]
    read = {"p1": 64, "p2": 4 * n, "p3": 128, "p4": 64}[case]
    n_out = 2 if case == "p4" else 1
    fp, it = (4 * n, 4 * n) if case == "p2" else (0, 0)
    return dict(bytes=read + 4 * n * n_out, fp32_ops=fp, int32_ops=it)


def kernel_resources(cases=CASES) -> dict:
    """{probe: (registers per thread, local memory bytes per thread)}."""
    return common.kernel_attrs(cudalib.lib().rt_probe_bitcast_attrs,
                               {case: CASES.index(case) for case in cases}, "probe_bitcast")


def run_case(case: str, device="cuda", tabs: Tables | None = None, out=print) -> dict:
    """One probe as the script runs it: the kernel (on the card 10 timed
    launches after a warm-up, the last one's outputs judged) and the
    script's verdict line."""
    tabs = tabs or reference_tables()
    tab, r0 = case_input(case, tabs, device)
    r, got = common.run_tile_case(lambda: probe_bitcast(case, tab, r0), tab.is_cuda,
                                  lambda: kernel_resources((case,))[case])
    r["verdict"], line = verdict(case, [g.cpu().numpy() for g in got], tabs)
    out(line + common.timing_suffix(r))
    return r


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = common.device_arg(argv, "bitcast")
    if argv:
        run_case(argv[0], device)
        return 0
    res = common.in_subprocesses(__spec__.name, CASES, device, status=("PASS", "CRASH"))
    return 0 if all(res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
