"""How much of the v5 traversal iteration is row loads, on the card: the
port of scripts/kernel_load_probe.py (its `make_kernel` :43, TPU call
:214).

Modes (probes/v5_body.py runs them): full16 (a node row and a triangle
row per chain, 16 per packet), loads8 (the node row reused as the
triangle row), loads0 (both rows made from chain 0's t_best + the task,
no table loads). loads8 and loads0 compute garbage by design; the
instruction stream downstream of the loads is the same.

    python -m raytracer_tpu_torch.probes.load_probe [iters]
"""

from __future__ import annotations

import sys

from raytracer_tpu_torch.probes import v5_body

MODES = ("full16", "loads8", "loads0")


def main(argv=None) -> int:
    return v5_body.main_of("load_probe", MODES, sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    sys.exit(main())
