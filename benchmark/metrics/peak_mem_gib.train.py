"""GiB at the card's allocation peak over the window
(torch.cuda.max_memory_allocated after a reset at the window's start)."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
