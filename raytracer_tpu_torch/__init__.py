"""raytracer_tpu_torch — the PyTorch + CUDA port of raytracer_tpu.

The JAX/Pallas package `raytracer_tpu` is the reference; this package
renders the same images on an NVIDIA H100 with hand-written CUDA
kernels (csrc/) and keeps a plain PyTorch version of every kernel
beside it. Module names follow the JAX package: `ops/cuda_traverse.py`
is the counterpart of `ops/pallas_traverse.py`, `ops/cuda_megakernel.py`
of `ops/pallas_megakernel.py`, and so on.

Nothing here imports `jax`: the machine with the card has none. Scenes
are built by the port itself (scene/builder.py) and random numbers come
from integer seeds with the same Threefry key words as
`jax.random.key(seed)`, so both packages draw identical bits.
"""

__version__ = "0.1.0"

import torch as _torch

# On the CPU, torch's float kernels for sqrt, cos, exp and the like hand a
# tensor to MKL's VML in chunks of 2,048 elements from several OpenMP
# threads at once. When that is the process's first VML call, the threads
# race in MKL's one-time set-up and a worker's chunk can come back at about
# 12 bits (sqrt off by up to 3e-4 relative), so a plain version's result
# depended on whether an earlier call had set VML up. One call on a single
# element, made here on one thread, sets it up before any of that.
_torch.sqrt(_torch.ones(1))
