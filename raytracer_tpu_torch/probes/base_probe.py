"""What is left of the v5 traversal iteration without loads, on the card:
the port of scripts/kernel_base_probe.py (its `make_kernel` :40, TPU call
:209).

Cumulative knockouts (probes/v5_body.py runs them): base (both rows made
from the chain's own t_best + its own task), noconcat (+ chain 0's task
instead of its own: on the card a shared task read after a block barrier,
where the TPU saved a cross-sublane concatenate), noc_nosc (+ no push/pop,
the task steps through 0..1000), minimal (the loop and the shared-memory
task alone). The script's kernel never reads the tables; its main() passes
them all the same, and so does this one.

    python -m raytracer_tpu_torch.probes.base_probe [iters]
"""

from __future__ import annotations

import sys

from raytracer_tpu_torch.probes import v5_body

MODES = ("base", "noconcat", "noc_nosc", "minimal")


def main(argv=None) -> int:
    return v5_body.main_of("base_probe", MODES, sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    sys.exit(main())
