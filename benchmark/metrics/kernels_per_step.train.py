"""Device kernels per training step (torch.profiler, traced steps)."""


def read(run):
    if run.trace is None:
        return None
    return run.trace["kernels"] / len(run.traced)
