"""Traversal-iteration probes on the card: fixed-iteration copies of the
TPU traversal body with one phase knocked out at a time (ports of
scripts/kernel_ablate_v8.py, kernel_ablate.py, kernel_load_probe.py and
kernel_floor_probe.py). Each module has an entry point that does what its
script's main() does:

    python -m raytracer_tpu_torch.probes.ablate_v8 [iters] [packets]
    python -m raytracer_tpu_torch.probes.ablate [iters]
    python -m raytracer_tpu_torch.probes.load_probe [iters]
    python -m raytracer_tpu_torch.probes.floor_probe [iters]

The kernels are csrc/probe_v8.cu and csrc/probe_v5.cu; the plain PyTorch
versions beside them take the same operations in the same order.
"""
