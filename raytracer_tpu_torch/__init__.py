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
