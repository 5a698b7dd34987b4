"""CUDA-graph replays per training step: `rt.train.replay` spans per
root (program span), one a chunk where diff/inverse.ChunkGraph replays
the chunk's forward and backward, 0 where the step ran them eagerly.
A program without ChunkGraph gives no reading."""

from benchmark.metrics._spans import count_per_root


def read(run):
    try:
        from raytracer_tpu_torch.diff.inverse import ChunkGraph  # noqa: F401
    except ImportError:
        return None
    return count_per_root(run, "rt.train.replay")
