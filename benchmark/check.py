"""The comparisons that decide `correct`. Each gives a number and its
limit; a run is correct when every number is at most its limit. The
limits live in the traffic mix's "check" record, with the readings they
were set from in PERF.md."""

from __future__ import annotations

import torch


def reference_config(cfg: dict) -> dict:
    """The render settings the reference reads from a configuration."""
    keys = ("resolution", "max_bounces", "min_bounces", "rr_max_prob", "t_min",
            "emission_quirk", "edge_aware_lights", "edge_bandwidth")
    return {k: cfg[k] for k in keys if k in cfg}


def mismatch_share(got: torch.Tensor, want: torch.Tensor, spec: dict) -> dict:
    """The share of compared values (pixel channels) that differ from the
    reference's by more than atol + rtol * |reference|. Both sides trace
    the same paths with the same draws, so a sound run differs only where
    rounding sends a path another way; a value that is wrong anywhere
    (a lost sample, a wrong hit, a wrong material) differs in most."""
    got, want = got.float().reshape(-1), want.float().reshape(-1)
    if got.shape != want.shape:
        raise ValueError(f"compared {got.shape} values against {want.shape}")
    bad = ~((got - want).abs() <= spec["atol"] + spec["rtol"] * want.abs())
    return dict(name="mismatch_share", value=float(bad.float().mean()), limit=spec["limit"])


def leaf_gap(prog: dict, ref: dict, name: str, limit: float, floor: float = 1e-3,
             weights: dict | None = None) -> dict:
    """Per leaf, the gap between the program's norm and the reference's
    over max(the reference's norm of that leaf, the median leaf's norm);
    the worst leaf's gap. Leaves whose reference norm (or `weights`, the
    reference's first gradient norms, where given) is under `floor` times
    the median leaf's move by rounding alone and are left out."""
    norms = sorted(ref.values())
    med = norms[len(norms) // 2]
    w = ref if weights is None else weights
    w_med = sorted(w.values())[len(w) // 2]
    gaps = sorted(abs(prog[k] - r) / max(r, med) for k, r in ref.items()
                  if w[k] >= floor * w_med)
    return dict(name=name, value=gaps[-1], limit=limit)


def rel_gap(prog: float, ref: float, name: str, limit: float) -> dict:
    return dict(name=name, value=abs(prog - ref) / max(abs(ref), 1e-30), limit=limit)
