"""Checkpoint and resume for long renders and training runs (port of
raytracer_tpu/io/checkpoint.py).

A resumable render accumulates its samples in batches and writes the
f32 sample sum and the count of samples done to an npz after every
batch; a restarted job goes on from the last batch. Draws are keyed by
(pixel, sample), so the resumed render is the uninterrupted one.

The files are the JAX package's, field for field: a render checkpoint
holds `acc`, `spp_done`, `spp_total`, `seed_hash` and `rng_stream`; a
training checkpoint `param_*`, `mu_*`, `nu_*`, `step` and `extra_*`.
`seed_hash` is the XOR of the key's two words, which for an integer
seed s is s mod 2^32 in both packages, so a checkpoint written by one
package resumes in the other.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def _atomic_save(path: str, **arrays) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    # The suffix must be ".npz": np.savez appends it otherwise and the
    # rename would move an empty file.
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _rng_stream_id(cfg, integrator: str) -> str:
    """The RNG stream an accumulation draws from: the fused integrator
    always draws the ktf counter stream, the others cfg.rng_impl. Mixing
    streams in one accumulator would break resumed == uninterrupted, so
    the stream is part of the checkpoint's header."""
    return "ktf" if (integrator == "fused" or cfg.rng_impl == "ktf") else "jax"


def _key_hash(key) -> int:
    """XOR of the key's uint32 words: those of jax.random.key(seed), (0,
    seed mod 2^32), for an integer seed, or of key words (k0, k1)."""
    if isinstance(key, tuple):
        words = np.concatenate([torch.as_tensor(k).cpu().numpy().reshape(-1) for k in key])
    else:
        words = np.asarray([0, int(key) & 0xFFFFFFFF], np.int64)
    return int(np.bitwise_xor.reduce(words.astype(np.uint32)))


def render_image_resumable(scene, cam, cfg, key, ckpt_path: str,
                           spp_per_batch: int | None = None, integrator: str = "wavefront"):
    """Resumable render: accumulates the samples in batches of
    `spp_per_batch` (cfg.spp_per_pass by default), saving (sample sum,
    samples done) after each. Returns the mean linear image f32[H,W,3]
    on the scene's device. `integrator`: "wavefront", "fused" or
    "megakernel". A checkpoint of another size, sample total, key or
    RNG stream, or one without a stream, is not resumed."""
    from raytracer_tpu_torch.render import iter_spp_accumulation

    spp_per_batch = spp_per_batch or cfg.spp_per_pass
    h, w = cfg.height, cfg.width
    stream = _rng_stream_id(cfg, integrator)
    seed_hash = _key_hash(key)

    done = 0
    acc = np.zeros((h, w, 3), np.float32)
    if os.path.exists(ckpt_path):
        with np.load(ckpt_path) as z:
            if (z["acc"].shape == acc.shape
                    and int(z["spp_total"]) == cfg.spp
                    and int(z["seed_hash"]) == seed_hash
                    and "rng_stream" in z.files
                    and str(z["rng_stream"]) == stream):
                acc = z["acc"]
                done = int(z["spp_done"])

    for done, batch_sum in iter_spp_accumulation(scene, cam, cfg, key, integrator=integrator,
                                                 spp_per_batch=spp_per_batch, start_done=done):
        acc = acc + batch_sum.cpu().numpy()
        _atomic_save(ckpt_path, acc=acc, spp_done=np.int64(done), spp_total=np.int64(cfg.spp),
                     seed_hash=np.int64(seed_hash), rng_stream=np.str_(stream))
    return torch.from_numpy(acc / cfg.spp).to(scene.materials.type.device)


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def save_train_state(path: str, params: dict, adam_state, extra: dict | None = None) -> None:
    """Params and Adam's state (diff/inverse.AdamState) to an npz."""
    arrays = {f"param_{k}": _numpy(v) for k, v in params.items()}
    arrays.update({f"mu_{k}": _numpy(v) for k, v in adam_state.mu.items()})
    arrays.update({f"nu_{k}": _numpy(v) for k, v in adam_state.nu.items()})
    arrays["step"] = np.asarray(adam_state.step)
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = _numpy(v)
    _atomic_save(path, **arrays)


def load_train_state(path: str):
    """save_train_state's file → (params, AdamState, extra): CPU tensors,
    extra as numpy."""
    from raytracer_tpu_torch.diff.inverse import AdamState

    def t(a):
        return torch.from_numpy(np.array(a))

    with np.load(path) as z:
        params = {k[6:]: t(z[k]) for k in z.files if k.startswith("param_")}
        mu = {k[3:]: t(z[k]) for k in z.files if k.startswith("mu_")}
        nu = {k[3:]: t(z[k]) for k in z.files if k.startswith("nu_")}
        step = int(z["step"])
        extra = {k[6:]: z[k] for k in z.files if k.startswith("extra_")}
    return params, AdamState(step=step, mu=mu, nu=nu), extra
