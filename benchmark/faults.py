"""Faults planted under a cell's timed path, to show that its check
fails them (benchmark/tests/test_bench_faults.py, on the CPU) and to read
each number they give at the cell's size (tools/readings.py --fault, on
the card). An entry names the program function its requests call
(`FAULT_TARGET`) and the faults it can have (`FAULTS`)."""

from __future__ import annotations

import contextlib
import importlib


def half_samples(orig):
    """Half of each request's samples left out, the mean taken over the rest."""
    def f(*a, spp=None, **k):
        return orig(*a, spp=max(1, spp // 2), **k)
    return f


def answer_altered(orig):
    """Every answer altered by 1% where it is produced."""
    def f(*a, **k):
        return orig(*a, **k) * 1.01
    return f


def stale_answer(orig):
    """Every request answered with the first request's image."""
    first = {}

    def f(*a, **k):
        if "img" not in first:
            first["img"] = orig(*a, **k)
        return first["img"]
    return f


def state_unchanged(orig):
    """A training step that returns its parameters and state unchanged."""
    def make(*a, **k):
        step = orig(*a, **k)

        def frozen(params, state):
            _, _, loss = step(params, state)
            return params, state, loss
        return frozen
    return make


def half_the_pairs(orig):
    """Half of the pairs left out, the mean taken over the rest."""
    def make(scene, cam, cfg, targets, keys, chunk=8, **k):
        h = targets.shape[0] // 2
        return orig(scene, cam, cfg, targets[:h], (keys[0][:h], keys[1][:h]),
                    chunk=max(1, min(chunk, h)), **k)
    return make


def loss_altered(orig):
    """Each step's loss altered by 1% where it is produced."""
    def make(*a, **k):
        step = orig(*a, **k)

        def wrong(params, state):
            p, s, loss = step(params, state)
            return p, s, loss * 1.01
        return wrong
    return make


def lr_scales_ignored(orig):
    """Each field's learning-rate scale ignored: every field steps at the
    base rate (in the job, the camera's three leaves have scales of their
    own)."""
    def make(*a, lr_scales=None, **k):
        return orig(*a, **k)
    return make


@contextlib.contextmanager
def plant(entry, name: str):
    """The program function that fault `name` breaks (the entry's
    FAULT_TARGET) replaced by the broken one inside the block."""
    if name not in entry.FAULTS:
        raise ValueError(f"fault {name!r} is not one of {entry.FAULTS}")
    module, attr = entry.FAULT_TARGET
    owner = importlib.import_module(module)
    orig = getattr(owner, attr)
    setattr(owner, attr, globals()[name](orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)
