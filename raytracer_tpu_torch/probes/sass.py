"""Static SASS instruction counts of the probe kernels in the built kernel
library (`cuobjdump -sass`), by kind. A probe's loop body is unrolled
except for the loop over iterations, so a kernel's count is close to one
iteration's instructions per thread: it shows what a knockout removed,
including what the compiler then dropped as dead. chip_smoke.py phase 13
prints them.
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
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
# A probe kernel's mangled name: its body and template argument (a variant,
# mode or case id; G itself for the interleave probe) and, for P-v8 and the
# v5 body, the chain width W, the scalar probe's tables pre-pass, the v6
# body (one kernel), or a morph variant (its five template arguments: the
# loop, then four flags).
_KERNEL = re.compile(r"probe_(v8|v5|interleave|scalar|vstack|ktf|mosaic|feature|bitcast)"
                     r"_kernelILi(\d+)E(?:Li(\d+)E)?"
                     r"|probe_(scalar)_(tables)_kernel|probe_(v6)_kernelE"
                     r"|probe_(morph)_kernelILi(\d)ELb([01])ELb([01])ELb([01])ELb([01])E")


def cuobjdump() -> str:
    """cuobjdump beside nvcc (the CUDA toolkit ships both)."""
    return os.path.join(os.path.dirname(cudalib._nvcc()), "cuobjdump")


def parse(sass: str) -> dict:
    """{(body, instantiation id): {"total": n, kind: n, ...}} of the probe
    kernels in cuobjdump -sass output; body is "v8", "v5", "interleave",
    "scalar", "vstack", "ktf", "mosaic", "feature", "bitcast", "v6" or
    "morph", the id an int ((id, W) for a v8 or v5 kernel of chain width W,
    "tables" for the scalar probe's pre-pass, 0 for v6, the five template
    arguments for morph)."""
    out, cur = {}, None
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
                cur = (k.group(6), 0)
            else:
                cur = ("morph", tuple(int(g) for g in k.groups()[7:12]))
            if cur is not None:
                out[cur] = dict.fromkeys(["total", *KINDS], 0)
            continue
        m = _INSN.search(line) if cur is not None else None
        if not m or m.group(1) == "NOP":
            continue
        op = m.group(1).split(".")[0]
        c = out[cur]
        c["total"] += 1
        for kind, ops in KINDS.items():
            if op in ops:
                c[kind] += 1
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
    """A kernel's name in its probe's own terms: "v8 <variant>", "v5 <mode>"
    (with " W<w>" for a kernel of chain width w), "interleave G<G>", "scalar
    <mode>" (or "scalar tables"), "vstack <case>", "ktf <case>", "mosaic
    <case>", "feature <stage>", "bitcast <probe>", "v6", "morph <variant>"."""
    from raytracer_tpu_torch.probes import (ablate_v8, bitcast, feature, ktf_probe, morph, mosaic,
                                            scalar_cost, v5_body, vstack)

    if body == "morph":
        return f"morph {morph.variant_of(i)}"
    if body == "interleave":
        return f"interleave G{i}"
    if i == "tables":
        return "scalar tables"
    if body == "v6":
        return "v6"
    names = {"v8": ablate_v8.VARIANTS, "v5": v5_body.MODES, "scalar": scalar_cost.MODES,
             "vstack": vstack.CASES, "ktf": ktf_probe.CASES, "mosaic": mosaic.CASES,
             "feature": feature.CASES, "bitcast": bitcast.CASES}
    if isinstance(i, tuple):
        return f"{body} {names[body][i[0]]} W{i[1]}"
    return f"{body} {names[body][i]}"


def by_name() -> dict:
    """{name(body, id): counts} of every probe kernel in the library."""
    return {name(body, i): c for (body, i), c in sorted(counts().items(), key=str)}
