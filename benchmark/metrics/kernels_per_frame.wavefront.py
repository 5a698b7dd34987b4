"""Device kernels per wavefront frame (torch.profiler, traced requests)."""


def read(run):
    if run.trace is None:
        return None
    return run.trace["kernels"] / len(run.traced)
