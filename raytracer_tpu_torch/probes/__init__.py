"""Traversal-iteration probes on the card: fixed-iteration copies of the
TPU traversal body with one phase knocked out at a time, and the small
kernels that cost one construct each (ports of scripts/kernel_ablate_v8.py,
kernel_ablate.py, kernel_load_probe.py, kernel_floor_probe.py,
kernel_base_probe.py, kernel_interleave_probe.py, scalar_cost_probe.py and
vstack_probe.py). Each module has an entry point that does what its
script's main() does:

    python -m raytracer_tpu_torch.probes.ablate_v8 [iters] [packets]
    python -m raytracer_tpu_torch.probes.ablate [iters]
    python -m raytracer_tpu_torch.probes.load_probe [iters]
    python -m raytracer_tpu_torch.probes.floor_probe [iters]
    python -m raytracer_tpu_torch.probes.base_probe [iters]
    python -m raytracer_tpu_torch.probes.interleave_probe [iters] [packets]
    python -m raytracer_tpu_torch.probes.scalar_cost [iters]
    python -m raytracer_tpu_torch.probes.vstack [p1|p2|p3]

The kernels are csrc/probe_v8.cu, probe_v5.cu, probe_interleave.cu,
probe_scalar.cu and probe_vstack.cu; the plain PyTorch versions beside
them take the same operations in the same order.
"""
