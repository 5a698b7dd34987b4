"""Differentiable inverse rendering (port of raytracer_tpu/diff/inverse.py).

Pixel gradients with respect to material albedo, roughness, IOR and
emission, and to the camera pose, flow through the differentiable path
(render.render_pixels: detached traversal, differentiable shading and
reparameterized sampling); `make_train_step*` builds an Adam step that
recovers them from target images.

Parameters are a plain dict of float32 tensors: the material fields of
DEFAULT_FIELDS and the camera fields of CAM_FIELDS. A step takes
(params, AdamState) and returns (params, AdamState, loss), like the JAX
step; `torch.autograd.grad` takes the place of `jax.value_and_grad`.

Averaging over K matched (key, target) pairs (JAX's vmap over pairs) is
one render of K·H·W lanes, each lane keyed by its own pair's key words;
the loss stays the mean of the per-pair means.

`make_train_step(mesh=...)` shards the pixels over a
parallel/sharding.Mesh: each shard's loss is its pixels' squared error
weighted 1/n (padding lanes 0), and the shards' losses and gradients
are summed (all_reduce under a process group, a host sum in one
process) before one Adam update.

`make_train_step_accum` on a card takes one chunk's loss and gradient
as one CUDA graph (ChunkGraph), captured in the first step and replayed
for every chunk; on the CPU it runs them eagerly.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.render import as_key, pixel_grid, render_pixels
from raytracer_tpu_torch.scene.types import Materials
from raytracer_tpu_torch.utils import profiling
from raytracer_tpu_torch.utils import rng as rngu
from raytracer_tpu_torch.utils.profiling import span

DEFAULT_FIELDS = ("albedo", "roughness", "emission", "ior")
# Camera-pose entries a params dict may carry beside the material fields.
CAM_FIELDS = ("cam_position", "cam_yaw", "cam_pitch", "cam_fov")
# ChunkGraph's captures and replays.
GRAPHS = profiling.group("train", ("graph_captures", "graph_replays"))


class AdamState(NamedTuple):
    step: int
    mu: dict
    nu: dict


def _lo(x, lo):
    """max(x, lo) with JAX's gradient (split in half at a tie)."""
    return torch.maximum(x, torch.full_like(x, lo))


def _hi(x, hi):
    return torch.minimum(x, torch.full_like(x, hi))


def _apply_params(scene, params: dict):
    """The scene with each material field of `params`, mapped into its
    render domain (albedo and roughness [0, 1], emission >= 0, ior [1, 3])."""
    mats = scene.materials
    kw = {f: getattr(mats, f) for f in ("type", "albedo", "emission", "roughness", "ior")}
    for name, val in params.items():
        if name in CAM_FIELDS:
            continue
        if name in ("albedo", "roughness"):
            val = _hi(_lo(val, 0.0), 1.0)
        elif name == "emission":
            val = _lo(val, 0.0)
        elif name == "ior":
            val = _hi(_lo(val, 1.0), 3.0)
        kw[name] = val
    return scene.replace(materials=Materials(**kw))


def _apply_cam(cam, params: dict):
    """The camera with any CAM_FIELDS of `params`. The focus distance
    stays the base camera's: with an aperture ~0 it only scales the
    (unnormalized) ray directions, so it is not a pose parameter."""
    kw = {}
    for name, field in (("cam_position", "position"), ("cam_yaw", "yaw"),
                        ("cam_pitch", "pitch"), ("cam_fov", "fov_degrees")):
        if name in params:
            kw[field] = params[name]
    return dataclasses.replace(cam, **kw) if kw else cam


def apply_domains(params: dict, reflect: bool = False) -> dict:
    """Map each field into its render domain (the rules of _apply_params).
    A raw value outside the domain renders as the boundary but gets zero
    gradient through the clip and freezes; `reflect=True` folds noised
    inits at the lower bound instead, so a perturbation stays inside the
    domain and away from a boundary truth."""
    out = dict(params)

    def lo_map(x, lo):
        return lo + torch.abs(x - lo) if reflect else _lo(x, lo)

    if "albedo" in out:
        out["albedo"] = _hi(lo_map(out["albedo"], 0.0), 1.0)
    if "roughness" in out:
        out["roughness"] = _hi(lo_map(out["roughness"], 0.0), 1.0)
    if "emission" in out:
        out["emission"] = lo_map(out["emission"], 0.0)
    if "ior" in out:
        out["ior"] = _hi(lo_map(out["ior"], 1.0), 3.0)
    return out


def init_params(scene, fields=DEFAULT_FIELDS, key=None, noise: float = 0.0) -> dict:
    """The scene's material fields, optionally noised: one subkey of
    split(key) per field in SORTED name order (the order in which JAX
    flattens a dict), each adding noise * jax.random.normal."""
    params = {f: getattr(scene.materials, f) for f in fields}
    if key is not None and noise > 0.0:
        names = sorted(params)
        sub = rngu.split(key, len(names))
        for i, name in enumerate(names):
            leaf = params[name]
            params[name] = leaf + noise * rngu.random_normal(
                (sub[0][i], sub[1][i]), tuple(leaf.shape)).to(leaf.device)
        params = apply_domains(params, reflect=True)
    return params


def adam_init(params: dict) -> AdamState:
    return AdamState(step=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()})


def cosine_lr(lr0: float, total_steps: int, lr_min_frac: float = 0.1):
    """Cosine decay lr0 → lr0·lr_min_frac over total_steps (then flat),
    in float32 like the JAX schedule."""
    f32 = np.float32

    def fn(step):
        t = np.minimum(f32(step), f32(total_steps)) / f32(total_steps)
        return float(f32(lr0) * (f32(lr_min_frac)
                                 + f32(1.0 - lr_min_frac) * f32(0.5) * (f32(1.0)
                                                                        + np.cos(f32(np.pi) * t))))

    return fn


def adam_update(state: AdamState, grads: dict, params: dict, lr=2e-2, b1=0.9, b2=0.999,
                eps=1e-8, lr_scales: dict | None = None):
    """Adam over a params dict. `lr_scales` maps a field name to a
    multiplier on lr for that field (Adam steps each field ~lr in its
    own units, and the fields' units differ by orders of magnitude)."""
    step = state.step + 1
    t = np.float32(step)
    c1 = float(np.float32(1.0) - np.power(np.float32(b1), t))
    c2 = float(np.float32(1.0) - np.power(np.float32(b2), t))
    mu, nu, new = {}, {}, {}
    for k in params:
        g = grads[k]
        mu[k] = b1 * state.mu[k] + (1 - b1) * g
        nu[k] = b2 * state.nu[k] + (1 - b2) * g * g
        step_lr = float(np.float32(lr) * np.float32((lr_scales or {}).get(k, 1.0)))
        new[k] = params[k] - step_lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
    return AdamState(step=step, mu=mu, nu=nu), new


def pairs_loss(base_scene, cam, cfg, params, keys, tgts, px, py):
    """Mean over pairs of the per-pair mean squared error / 3: keys
    (k0, k1) [K], targets f32[K, P, 3] for the pixels (px, py) [P]. One
    render of K·P lanes, lane j·P + i = pixel i under key j."""
    k, p = tgts.shape[0], px.shape[0]
    lane_keys = (keys[0].repeat_interleave(p), keys[1].repeat_interleave(p))
    scene = _apply_params(base_scene, params)
    rgb = render_pixels(scene, _apply_cam(cam, params), px.repeat(k), py.repeat(k), cfg,
                        lane_keys).reshape(k, p, 3)
    d = rgb - tgts
    sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    return torch.mean(torch.mean(sq, dim=1) / 3.0)


def value_and_grad(loss_fn, params: dict):
    """(loss, {name: gradient}) of loss_fn(params) at detached copies of
    `params` (an unused field gets a zero gradient). The spans
    `rt.train.forward` and `rt.train.backward` hold the two halves."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with span("rt.train.forward"):
        loss = loss_fn(leaves)
    with span("rt.train.backward"):
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def _on(device, cam, keys):
    return cam.to(device), (keys[0].to(device), keys[1].to(device))


def make_train_step_multi(base_scene, cam, cfg, targets, keys, lr: float = 2e-2, lr_fn=None,
                          lr_scales: dict | None = None):
    """Adam step whose gradient averages over K matched (key, target)
    pairs: targets f32[K,H,W,3], keys (k0, k1) [K] (keys[j] rendered
    targets[j]). `lr_fn(step)` overrides the constant lr (cosine_lr)."""
    dev = base_scene.materials.type.device
    px, py = pixel_grid(cfg, dev)
    tgts = targets.to(dev).reshape(targets.shape[0], -1, 3)
    cam, keys = _on(dev, cam, keys)

    def train_step(params, adam_state):
        loss, grads = value_and_grad(
            lambda p: pairs_loss(base_scene, cam, cfg, p, keys, tgts, px, py), params)
        cur_lr = lr_fn(adam_state.step) if lr_fn is not None else lr
        adam_state, params = adam_update(adam_state, grads, params, lr=cur_lr,
                                         lr_scales=lr_scales)
        return params, adam_state, loss

    return train_step


# Pixels of one pair that ChunkGraph's warm-up renders before the capture.
WARM_UP_PIXELS = 64


class ChunkGraph:
    """One chunk's loss and gradient, value_and_grad of loss_fn(params,
    keys, targets, px, py) at the pixels (px, py), as one CUDA graph
    replayed for every chunk: the chunks share their shapes and sample
    offsets, so only the params, keys and targets change between
    replays, and they are copied into the graph's static inputs.

    The first step warms up on a side stream, with the loss of one pair's
    first WARM_UP_PIXELS pixels (what a capture cannot do, such as
    building the kernel library or a device constant, is done by then;
    kernels of other sizes load during the capture), then captures the
    forward and torch.autograd.grad over static leaves. Every chunk,
    the first step's too, replays the graph (span `rt.train.replay`).
    The loss and gradients live in the graph's memory pool, and the next
    replay overwrites them."""

    def __init__(self, loss_fn, px, py):
        self.loss_fn, self.px, self.py = loss_fn, px, py
        self.graph = None

    def step(self, params: dict, parts):
        """(loss, gradients) of each chunk of `parts` at `params`, each
        yielded before the next chunk runs."""
        if self.graph is None:
            self._capture(params, parts[0])
        with torch.no_grad():
            for k, leaf in self.leaves.items():
                leaf.copy_(params[k])
        for (k0, k1), tgts in parts:
            self.keys[0].copy_(k0)
            self.keys[1].copy_(k1)
            self.tgts.copy_(tgts)
            with span("rt.train.replay"):
                self.graph.replay()
                GRAPHS.count("graph_replays")
            yield self.loss, self.grads

    def _capture(self, params: dict, part):
        (k0, k1), tgts = part
        n = WARM_UP_PIXELS
        main = torch.cuda.current_stream(self.px.device)
        side = torch.cuda.Stream(self.px.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            value_and_grad(lambda p: self.loss_fn(p, (k0[:1], k1[:1]), tgts[:1, :n],
                                                  self.px[:n], self.py[:n]), params)
        main.wait_stream(side)
        self.leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        self.keys, self.tgts = (k0.clone(), k1.clone()), tgts.clone()
        self.graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph synchronizes and releases the cached blocks
        # before it captures into the graph's own pool.
        with torch.cuda.graph(self.graph):
            loss = self.loss_fn(self.leaves, self.keys, self.tgts, self.px, self.py)
            grads = torch.autograd.grad(loss, list(self.leaves.values()), allow_unused=True)
        self.loss = loss.detach()
        self.grads = {k: torch.zeros_like(v) if g is None else g
                      for (k, v), g in zip(self.leaves.items(), grads)}
        GRAPHS.count("graph_captures")


def _chunk_sums(chunks):
    """The sums of the chunks' losses and gradients, each chunk's taken
    before the next chunk is made."""
    loss_sum = grad_sum = None
    for loss_c, grads_c in chunks:
        if grad_sum is None:
            loss_sum, grad_sum = loss_c.clone(), {k: g.clone() for k, g in grads_c.items()}
        else:
            loss_sum = loss_sum + loss_c
            grad_sum = {k: grad_sum[k] + grads_c[k] for k in grad_sum}
    return loss_sum, grad_sum


def make_train_step_accum(base_scene, cam, cfg, targets, keys, chunk: int = 8,
                          lr: float = 2e-2, lr_fn=None, lr_scales: dict | None = None):
    """make_train_step_multi at K pairs, with the gradient accumulated
    over K/chunk renders of `chunk` pairs each, so peak memory is one
    chunk's graph. Equal chunks partition the pairs, so the mean of the
    chunk means is the K-pair mean. With the scene on a card the chunks
    run through one ChunkGraph; on the CPU eagerly."""
    k_total = targets.shape[0]
    if k_total % chunk:
        raise ValueError(f"{k_total} pairs do not split into chunks of {chunk}")
    n_chunks = k_total // chunk
    dev = base_scene.materials.type.device
    px, py = pixel_grid(cfg, dev)
    tgts = targets.to(dev).reshape(k_total, -1, 3)
    cam, keys = _on(dev, cam, keys)
    parts = [((keys[0][i * chunk:(i + 1) * chunk], keys[1][i * chunk:(i + 1) * chunk]),
              tgts[i * chunk:(i + 1) * chunk]) for i in range(n_chunks)]

    loss_fn = functools.partial(pairs_loss, base_scene, cam, cfg)
    graph = ChunkGraph(loss_fn, px, py) if dev.type == "cuda" else None

    def train_step(params, adam_state):
        with span("rt.train.step", root=True):
            chunks = (graph.step(params, parts) if graph is not None else
                      (value_and_grad(lambda p: loss_fn(p, kc, tc, px, py), params)
                       for kc, tc in parts))
            loss_sum, grad_sum = _chunk_sums(chunks)
            inv = 1.0 / n_chunks
            grads = {k: g * inv for k, g in grad_sum.items()}
            cur_lr = lr_fn(adam_state.step) if lr_fn is not None else lr
            adam_state, params = adam_update(adam_state, grads, params, lr=cur_lr,
                                             lr_scales=lr_scales)
            return params, adam_state, loss_sum * inv

    return train_step


def weighted_loss(base_scene, cam, cfg, params, key, px, py, tgt, weight):
    """sum(weight · squared error over the channels) / 3 of the pixels
    (px, py) against tgt f32[P, 3]: with weights 1/n on the real pixels
    and 0 on padding, the shards' sum is the mean loss."""
    rgb = render_pixels(_apply_params(base_scene, params), _apply_cam(cam, params), px, py, cfg,
                        key)
    d = rgb - tgt
    sq = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    return torch.sum(sq * weight) / 3.0


def _sharded_train_step(base_scene, cam, cfg, target, mesh, lr, lr_scales):
    from raytracer_tpu_torch.parallel.sharding import Mesh, _padded_pixel_grid, _shard_lanes
    from raytracer_tpu_torch.utils.cudalib import device_scope

    if not isinstance(mesh, Mesh):
        raise TypeError(f"make_train_step: mesh must be a parallel.sharding.Mesh, got "
                        f"{type(mesh).__name__}")
    px, py, n = _padded_pixel_grid(cfg, mesh.size)
    pad = px.shape[0] - n
    tgt = torch.cat([target.detach().reshape(-1, 3).cpu().to(torch.float32),
                     torch.zeros((pad, 3), dtype=torch.float32)])
    w = torch.cat([torch.full((n,), 1.0 / n, dtype=torch.float32),
                   torch.zeros((pad,), dtype=torch.float32)])
    per = px.shape[0] // mesh.size
    # The camera on each shard's device, as the unsharded step puts it on
    # the scene's.
    shards = {s: (sc, cam.to(x.device), x, y, tgt[s * per:(s + 1) * per].to(x.device),
                  w[s * per:(s + 1) * per].to(x.device))
              for s, (sc, x, y) in _shard_lanes(mesh, base_scene, px, py).items()}

    def train_step(params, adam_state, key):
        names = list(params)
        local = {}
        for s, (sc, c, x, y, t, ws) in shards.items():
            dev = x.device
            k = as_key(key, dev)
            with device_scope(dev):   # the kernels launch on the shard's card
                loss, grads = value_and_grad(
                    lambda p: weighted_loss(sc, c, cfg, p, k, x, y, t, ws),
                    {name: params[name].to(dev) for name in names})
            local[s] = torch.cat([loss.reshape(1)] + [grads[name].reshape(-1) for name in names])
        # One all-reduce of the loss and every gradient: the weights sum to
        # 1 over the shards, so the sum completes the mean.
        total = mesh.all_sum(local)
        home = params[names[0]].device
        loss, flat, grads = total[0].to(home), total[1:], {}
        for name in names:
            m = params[name].numel()
            grads[name] = flat[:m].reshape(params[name].shape).to(home)
            flat = flat[m:]
        adam_state, params = adam_update(adam_state, grads, params, lr=lr, lr_scales=lr_scales)
        return params, adam_state, loss

    return train_step


def make_train_step(base_scene, cam, cfg, target, mesh=None, lr: float = 2e-2,
                    lr_scales: dict | None = None):
    """train_step(params, adam_state, key) → (params, adam_state, loss)
    against one linear target f32[H,W,3]; initialize the optimizer state
    with adam_init(params). With `mesh` (parallel/sharding.Mesh) the
    pixels are sharded over it and the gradients summed over the shards."""
    if mesh is not None:
        return _sharded_train_step(base_scene, cam, cfg, target, mesh, lr, lr_scales)
    dev = base_scene.materials.type.device
    px, py = pixel_grid(cfg, dev)
    tgt = target.to(dev).reshape(1, -1, 3)
    cam = cam.to(dev)

    def train_step(params, adam_state, key):
        k0, k1 = as_key(key, dev)
        keys = (k0.reshape(1), k1.reshape(1))
        loss, grads = value_and_grad(
            lambda p: pairs_loss(base_scene, cam, cfg, p, keys, tgt, px, py), params)
        adam_state, params = adam_update(adam_state, grads, params, lr=lr,
                                         lr_scales=lr_scales)
        return params, adam_state, loss

    return train_step
