"""K3's device milliseconds per request in the spheres-only cell (its
instantiation with the sphere tree: torch.profiler, summed by kernel name
over the traced requests and over the cards)."""

from benchmark.metrics._common import kernel_s


def read(run):
    k3 = kernel_s(run, "k3")
    return None if k3 is None else 1e3 * k3 / len(run.traced)
