"""Static SASS instruction counts of the probe kernels in the built kernel
library (`cuobjdump -sass`), by kind. A probe's loop body is unrolled
except for the loop over iterations, so a kernel's count is close to one
iteration's instructions per thread: it shows what a knockout removed,
including what the compiler then dropped as dead. Where a kernel has more
than one loop (P-morph's brute pre-pass before its walk), `loops` and
`straight` split the count: each outermost loop's instructions, and those
outside every loop up to the kernel's exit. chip_smoke.py phase 13 prints
them.
"""

from __future__ import annotations

import os
import re
import subprocess

from raytracer_tpu_torch.utils import cudalib

# Kinds by opcode (the part before the first '.'); every other opcode
# counts in `total` only.
KINDS = {
    "fp32": {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK", "MUFU", "FSET"},
    "int": {"IADD3", "IMAD", "IABS", "IMNMX", "ISETP", "LOP3", "SHF", "SEL", "LEA", "F2I", "I2F",
            "POPC", "FLO", "PRMT"},
    "shfl": {"SHFL"},
    "shared": {"LDS", "STS"},
    "global": {"LDG", "STG"},
    "local": {"LDL", "STL"},
    "sync": {"WARPSYNC", "BAR", "BSSY", "BSYNC", "NANOSLEEP"},
    "branch": {"BRA", "BRX", "JMP", "EXIT", "RET", "CALL"},
}
_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([^;]*)")
_TARGET = re.compile(r"\b0x([0-9a-f]+)\s*$")   # a branch's absolute target
# A probe kernel's mangled name: its body and template argument (a variant,
# mode or case id; G itself for the interleave probe) and, for P-v8, the v5
# body and the interleave probe, the chain width W, the scalar probe's
# tables pre-pass, the v6 body (one kernel per W; the parent's form has no
# W), or a morph variant (its five template arguments: the loop, then four
# flags; then W).
_KERNEL = re.compile(r"probe_(v8|v5|interleave|scalar|vstack|ktf|mosaic|feature|bitcast)"
                     r"_kernelILi(\d+)E(?:Li(\d+)E)?"
                     r"|probe_(scalar)_(tables)_kernel|probe_(v6)_kernel(?:ILi(\d+)EE|E)"
                     r"|probe_(morph)_kernelILi(\d)ELb([01])ELb([01])ELb([01])ELb([01])E"
                     r"(?:Li(\d+)E)?")


def cuobjdump() -> str:
    """cuobjdump beside nvcc (the CUDA toolkit ships both)."""
    return os.path.join(os.path.dirname(cudalib._nvcc()), "cuobjdump")


def _top_loops(insns) -> tuple[list[tuple[int, int]], list[int], dict]:
    """(the outermost loops as (first, last) instruction indices, in order;
    the indices of EXIT and RET; {address: index}) of one kernel's
    [(address, opcode, operands)]."""
    at = {a: i for i, (a, _, _) in enumerate(insns)}
    ends = [i for i, (_, op, _) in enumerate(insns) if op in ("EXIT", "RET")]
    found = []
    for i, (a, op, rest) in enumerate(insns):
        m = _TARGET.search(rest.strip()) if op == "BRA" else None
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in at:
            t = at[int(m.group(1), 16)]
            if not any(t <= e <= i for e in ends):
                found.append((t, i))
    top = sorted((t, i) for t, i in found
                 if not any(t2 <= t and i <= i2 and (t2, i2) != (t, i) for t2, i2 in found))
    return top, ends, at


def loops(insns) -> tuple[list[int], int]:
    """(each outermost loop's instruction count, in order; the instructions
    outside them up to the first EXIT after the last) of one kernel's
    [(address, opcode, operands)], NOPs left out. A loop is a branch back
    to an earlier address with no EXIT or RET between the two: the
    compiler's cold blocks (a trap, a slow reciprocal, a divergent
    shuffle's fallback) sit after the exit and branch back into the body,
    and are not loops."""
    top, ends, _ = _top_loops(insns)
    last = top[-1][1] if top else -1
    end = next((e for e in ends if e > last), len(insns) - 1)
    inside = {k for t, i in top for k in range(t, i + 1)}
    return [i - t + 1 for t, i in top], sum(1 for k in range(end + 1) if k not in inside)


def loop_min(insns) -> list[int]:
    """The fewest instructions on any path from each outermost loop's first
    instruction to its branch back, in order: one pass through the body
    that issues the least, a branch forward within the body taken or not
    (an unconditional one's fall-through too), a branch out of it or back
    inside it not taken. A warp issues at least this many per trip."""
    top, _, at = _top_loops(insns)
    out = []
    for t, i in top:
        dist = [None] * (i - t + 1)
        dist[0] = 1
        for k in range(t, i):
            d = dist[k - t]
            if d is None:
                continue
            nxt = [k + 1]
            a, op, rest = insns[k]
            m = _TARGET.search(rest.strip()) if op == "BRA" else None
            if m and at.get(int(m.group(1), 16), -1) > k and at[int(m.group(1), 16)] <= i:
                nxt.append(at[int(m.group(1), 16)])
            for j in nxt:
                if dist[j - t] is None or d + 1 < dist[j - t]:
                    dist[j - t] = d + 1
        out.append(dist[i - t])
    return out


def parse(sass: str) -> dict:
    """{(body, instantiation id): {"total": n, kind: n, ..., "loops": [n,
    ...], "straight": n, "loop_min": [n, ...]}} of the probe kernels in
    cuobjdump -sass output (`loops`, `straight`: loops(); `loop_min`:
    loop_min()); body is "v8", "v5", "interleave",
    "scalar", "vstack", "ktf", "mosaic", "feature", "bitcast", "v6" or
    "morph", the id an int ((id, W) for a v8, v5 or interleave kernel of
    chain width W, "tables" for the scalar probe's pre-pass, 0 for v6 ((0,
    W) for the kernel of chain width W), the five template arguments for
    morph, with W as (args, W))."""
    out, insns, cur = {}, {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            k = _KERNEL.search(m.group(1))
            if k is None:
                cur = None
            elif k.group(1):
                cur = (k.group(1), int(k.group(2)) if k.group(3) is None
                       else (int(k.group(2)), int(k.group(3))))
            elif k.group(4):
                cur = (k.group(4), k.group(5))
            elif k.group(6):
                cur = (k.group(6), 0 if k.group(7) is None else (0, int(k.group(7))))
            else:
                args = tuple(int(g) for g in k.groups()[8:13])
                cur = ("morph", args if k.group(14) is None else (args, int(k.group(14))))
            if cur is not None:
                out[cur] = dict.fromkeys(["total", *KINDS], 0)
                insns[cur] = []
            continue
        m = _INSN.search(line) if cur is not None else None
        if not m or m.group(2) == "NOP":
            continue
        insns[cur].append((int(m.group(1), 16), m.group(2), m.group(3)))
        op = m.group(2).split(".")[0]
        c = out[cur]
        c["total"] += 1
        for kind, ops in KINDS.items():
            if op in ops:
                c[kind] += 1
    for key, c in out.items():
        c["loops"], c["straight"] = loops(insns[key])
        c["loop_min"] = loop_min(insns[key])
    return out


def counts(lib_path: str | None = None) -> dict:
    """parse() of the library at lib_path (the built one by default)."""
    lib_path = lib_path or cudalib.build()
    res = subprocess.run([cuobjdump(), "-sass", lib_path], capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {res.stderr[-2000:]}")
    return parse(res.stdout)


def name(body: str, i) -> str:
    """A kernel's name in its probe's own terms: "v8 <variant>", "v5 <mode>",
    "interleave G<G>", "morph <variant>" (each with " W<w>" for a kernel of
    chain width w), "scalar <mode>" (or "scalar tables"), "vstack <case>",
    "ktf <case>", "mosaic <case>", "feature <stage>", "bitcast <probe>",
    "v6" (" W<w>" for a kernel of chain width w)."""
    from raytracer_tpu_torch.probes import (ablate_v8, bitcast, feature, ktf_probe, morph, mosaic,
                                            scalar_cost, v5_body, vstack)

    if body == "morph":
        return (f"morph {morph.variant_of(i[0])} W{i[1]}" if isinstance(i[0], tuple)
                else f"morph {morph.variant_of(i)}")
    if body == "interleave":
        return f"interleave G{i[0]} W{i[1]}" if isinstance(i, tuple) else f"interleave G{i}"
    if i == "tables":
        return "scalar tables"
    if body == "v6":
        return f"v6 W{i[1]}" if isinstance(i, tuple) else "v6"
    names = {"v8": ablate_v8.VARIANTS, "v5": v5_body.MODES, "scalar": scalar_cost.MODES,
             "vstack": vstack.CASES, "ktf": ktf_probe.CASES, "mosaic": mosaic.CASES,
             "feature": feature.CASES, "bitcast": bitcast.CASES}
    if isinstance(i, tuple):
        return f"{body} {names[body][i[0]]} W{i[1]}"
    return f"{body} {names[body][i]}"


def by_name() -> dict:
    """{name(body, id): counts} of every probe kernel in the library."""
    return {name(body, i): c for (body, i), c in sorted(counts().items(), key=str)}
