"""Camera paths (pixels x samples) of all requests in the window over the
window's seconds: throughput toward a converged image."""


def read(run):
    return run.work / run.window_s
