"""Seconds from the start of the harness to the first timed request:
imports, the CUDA context, the kernel library (its build on a checkout's
first run), the scene and its tree, the entry's warm-up."""


def read(run):
    return run.setup_s
