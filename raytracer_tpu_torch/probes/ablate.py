"""Per-iteration phase ablation of the v5 traversal body on the card: the
port of scripts/kernel_ablate.py (its `make_kernel` :33, TPU call :213).

Variants (probes/v5_body.py runs them): full, no_leaf, no_internal,
no_scalar, no_fetch, on the reference scene's 4-wide tree in the v5
tables, 128 packets of 1,024 seeded rays, 119 iterations by default.

    python -m raytracer_tpu_torch.probes.ablate [iters]
"""

from __future__ import annotations

import sys

from raytracer_tpu_torch.probes import v5_body

VARIANTS = ("full", "no_leaf", "no_internal", "no_scalar", "no_fetch")


def main(argv=None) -> int:
    return v5_body.main_of("ablate", VARIANTS, sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    sys.exit(main())
