"""The loop floor of the v5 traversal iteration on the card, and the body
with its task state in shared memory or in registers: the port of
scripts/kernel_floor_probe.py (its `make_kernel` :48, TPU call :263).

Modes (probes/v5_body.py runs them): empty (the loop alone), carry8 (the
chain's task stepped in registers), smem8 (the same through shared
memory), prod_smem and prod_carry (the full body with task and stack
pointer in shared memory or in registers; the stack stays in shared
memory in both).

    python -m raytracer_tpu_torch.probes.floor_probe [iters]
"""

from __future__ import annotations

import sys

from raytracer_tpu_torch.probes import v5_body

MODES = ("empty", "carry8", "smem8", "prod_smem", "prod_carry")


def main(argv=None) -> int:
    return v5_body.main_of("floor_probe", MODES, sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    sys.exit(main())
