"""Traversal-iteration probes on the card: fixed-iteration copies of the
TPU traversal body with one phase knocked out at a time, and the small
kernels that cost one construct each (ports of scripts/kernel_ablate_v8.py,
kernel_ablate.py, kernel_load_probe.py, kernel_floor_probe.py,
kernel_base_probe.py, kernel_interleave_probe.py, scalar_cost_probe.py,
vstack_probe.py, ktf_kernel_probe.py, kernel_v6_probe.py, kernel_morph.py,
mosaic_probe.py, bitcast_probe.py and kernel_feature_probe.py). Each module
has an entry point that does what its script does from the command line:

    python -m raytracer_tpu_torch.probes.ablate_v8 [iters] [packets]
    python -m raytracer_tpu_torch.probes.ablate [iters]
    python -m raytracer_tpu_torch.probes.load_probe [iters]
    python -m raytracer_tpu_torch.probes.floor_probe [iters]
    python -m raytracer_tpu_torch.probes.base_probe [iters]
    python -m raytracer_tpu_torch.probes.interleave_probe [iters] [packets]
    python -m raytracer_tpu_torch.probes.scalar_cost [iters]
    python -m raytracer_tpu_torch.probes.vstack [p1|p2|p3]
    python -m raytracer_tpu_torch.probes.ktf_probe [case]
    python -m raytracer_tpu_torch.probes.v6 [packets]
    python -m raytracer_tpu_torch.probes.morph [variant]
    python -m raytracer_tpu_torch.probes.mosaic
    python -m raytracer_tpu_torch.probes.bitcast [p1|p2|p3|p4]
    python -m raytracer_tpu_torch.probes.feature [s1..s7]

Without a name, the entry points whose scripts run each case in a fresh
process (vstack, ktf_probe, morph, bitcast, feature) do the same. The
kernels are csrc/probe_*.cu and probe_*.cuh; the plain PyTorch versions
beside them take the same operations in the same order. On a machine
without CUDA the entry points stop with a message (`--device cpu` asks
for the plain versions instead, where the module takes it).
"""
