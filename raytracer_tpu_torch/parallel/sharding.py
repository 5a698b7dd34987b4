"""Renders sharded over several devices (port of
raytracer_tpu/parallel/sharding.py).

A `Mesh` is an ordered list of devices over named axes. The pixel (ray)
axis is split into equal shards, shard s on devices[s]; scene and camera
are shared. The forward render needs no collective: draws are keyed
by (pixel, sample, bounce), so every sharded render is the single-device
render of the same lanes.

Two transports run the same shard code:

  * in one process (`make_mesh`, `make_mesh_2d`), every shard is
    rendered in turn on its device, and the JAX package's collectives
    become host-side concatenation and sums. A device may appear more
    than once (["cuda:0"] * 4 shards one card);
  * under an initialized torch.distributed process group
    (parallel/multihost.global_mesh), each rank renders its own shard
    and the collectives are all_gather / all_reduce. With the gloo
    backend they run on host copies (several ranks may share one card);
    with nccl on the devices.

The rebalanced wavefront (models/wavefront.render_pixels_wavefront_rebalanced)
takes the mesh's all_gather as its transport; the mesh-sharded train
step (diff/inverse.make_train_step) its all_sum.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from raytracer_tpu_torch.render import render_pixels
from raytracer_tpu_torch.utils.cudalib import device_scope

RAY_AXIS = "rays"
SPP_AXIS = "spp"
PACKET = 1024

_log = logging.getLogger(__name__)


def _device(d) -> torch.device:
    """A torch.device with its index: a bare "cuda" is the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Devices over named axes, row-major: shard s of a 2D (rays × spp)
    mesh is ray block s // n_spp, sample window s % n_spp. `group` is the
    torch.distributed process group (None: every shard in this process);
    under a group, shard s is rank s, and only devices[rank] is this
    process's device (the others stand for the other ranks')."""

    def __init__(self, devices, axis_names=(RAY_AXIS,), shape=None, group=None):
        self.devices = tuple(_device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        shape = (len(self.devices),) if shape is None else tuple(int(x) for x in shape)
        if int(np.prod(shape)) != len(self.devices) or len(shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {shape} over axes {self.axis_names} does not fit "
                             f"{len(self.devices)} devices")
        self.shape = dict(zip(self.axis_names, shape))
        self.group = group
        if group is not None:
            import torch.distributed as dist

            if dist.get_world_size(group) != len(self.devices):
                raise ValueError(f"a mesh under a process group needs one device per rank: "
                                 f"{len(self.devices)} devices, "
                                 f"{dist.get_world_size(group)} ranks")
            self.rank = dist.get_rank(group)

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_shards(self) -> list:
        """The shards this process renders."""
        return list(range(self.size)) if self.group is None else [self.rank]

    @property
    def home(self) -> torch.device:
        """Where a gathered result lands: devices[0] in one process, this
        rank's device under a group."""
        return self.devices[0] if self.group is None else self.devices[self.rank]

    def _host(self) -> bool:
        import torch.distributed as dist

        return dist.get_backend(self.group) == "gloo"

    def _gather_list(self, t: torch.Tensor) -> list:
        import torch.distributed as dist

        src = t.cpu() if self._host() else t.contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return out

    def all_gather(self, local: dict) -> dict:
        """{shard: tensor [m, ...]} of the local shards → {shard: every
        shard's tensors concatenated in shard order, on that shard's
        device}. Every shard gives the same shape."""
        if self.group is None:
            return {s: torch.cat([local[t].to(self.devices[s]) for t in range(self.size)])
                    for s in local}
        (s,) = local
        return {s: torch.cat(self._gather_list(local[s])).to(self.devices[s])}

    def gather(self, local: dict) -> torch.Tensor:
        """Every shard's tensor concatenated in shard order, on `home`."""
        if self.group is None:
            return torch.cat([local[s].to(self.home) for s in range(self.size)])
        (s,) = local
        return torch.cat(self._gather_list(local[s])).to(self.home)

    def all_sum(self, local: dict) -> torch.Tensor:
        """The sum over every shard of its tensor (all the same shape), on
        `home`: in shard order in one process, all_reduce(SUM) under a
        group."""
        if self.group is None:
            total = None
            for s in range(self.size):
                t = local[s].to(self.home)
                total = t if total is None else total + t
            return total
        import torch.distributed as dist

        (s,) = local
        t = local[s].cpu() if self._host() else local[s].clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t.to(self.home)


def make_mesh(devices=None, axis_name: str = RAY_AXIS) -> Mesh:
    """A 1D in-process mesh over `devices` (names or torch.devices; one
    may repeat), by default every visible CUDA card. Without a card and
    without `devices` it raises: it never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA card is visible; pass devices= "
                               "(e.g. ['cpu'] * 8) to shard on other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices, (axis_name,))


def make_mesh_2d(n_ray_shards: int, n_spp_shards: int, devices=None) -> Mesh:
    """A 2D (rays × spp) in-process mesh: pixels shard over `rays`, the
    sample budget splits over `spp`. Takes the first n_ray·n_spp of
    `devices` (default: every visible card); raises on too few."""
    devices = list(make_mesh(devices).devices)
    need = n_ray_shards * n_spp_shards
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(devices[:need], (RAY_AXIS, SPP_AXIS), (n_ray_shards, n_spp_shards))


def replicate_scene(scene, mesh: Mesh) -> dict:
    """{device: the scene on it} for each distinct device of this
    process's shards (the scene itself where it already lies there)."""
    out = {}
    for s in mesh.local_shards():
        dev = mesh.devices[s]
        if dev not in out:
            out[dev] = scene if _device(scene.materials.type.device) == dev else scene.to(dev)
    return out


def _interleave_packets(px, py, n_shards: int):
    """Round-robin packet → shard permutation: shard s takes the
    1024-lane packets s, s+S, s+2S, ..., so every shard gets a like mix
    of screen regions (per-shard path cost varies ~1.8x max/mean across
    the screen, DRAIN_BALANCE_r03.json, and a frame ends at its slowest
    shard). Returns (px, py, unperm); unperm is None, and the shards are
    contiguous, when the packet count does not divide by the shards."""
    g = px.shape[0] // PACKET
    if g % n_shards:
        _log.info("packet interleave disabled: %d packets not divisible by %d shards "
                  "(contiguous assignment)", g, n_shards)
        return px, py, None
    perm = np.concatenate([np.arange(s, g, n_shards) for s in range(n_shards)])
    lanes = (perm[:, None] * PACKET + np.arange(PACKET)[None, :]).reshape(-1)
    unperm = np.empty_like(lanes)
    unperm[lanes] = np.arange(lanes.size)
    lanes = torch.from_numpy(lanes).to(px.device)
    return px[lanes], py[lanes], torch.from_numpy(unperm).to(px.device)


def _padded_pixel_grid(cfg, n_shards: int):
    """Full-image pixel ids (row 0 = top), padded to a multiple of the
    shard count with pixel (0, 0); the padding is sliced off after the
    gather. Returns (px, py, n real pixels)."""
    n = cfg.width * cfg.height
    pad = (-n) % n_shards
    xs = np.tile(np.arange(cfg.width, dtype=np.int32), cfg.height)
    ys = np.repeat(np.arange(cfg.height - 1, -1, -1, dtype=np.int32), cfg.width)
    px = np.concatenate([xs, np.zeros(pad, np.int32)])
    py = np.concatenate([ys, np.zeros(pad, np.int32)])
    return torch.from_numpy(px), torch.from_numpy(py), n


def _shard_lanes(mesh: Mesh, scene, px, py, n_blocks: int | None = None) -> dict:
    """{shard: (scene, px, py)} on each local shard's device: block
    s // (S / n_blocks) of n_blocks equal lane blocks (n_blocks = S: one
    block per shard). The camera stays where the caller put it: its
    basis is computed on its own device, as in the single-device render
    (an ulp of cos or tan there moves every ray)."""
    n_blocks = mesh.size if n_blocks is None else n_blocks
    per = px.shape[0] // n_blocks
    reps = mesh.size // n_blocks
    scenes = replicate_scene(scene, mesh)
    out = {}
    for s in mesh.local_shards():
        dev, b = mesh.devices[s], s // reps
        out[s] = (scenes[dev], px[b * per:(b + 1) * per].to(dev),
                  py[b * per:(b + 1) * per].to(dev))
    return out


def _per_shard(lanes: dict, fn) -> dict:
    """{shard: fn(shard, scene, px, py)} over _shard_lanes' result, each
    with its shard's card current (the kernels launch there)."""
    out = {}
    for s, (sc, x, y) in lanes.items():
        with device_scope(x.device):
            out[s] = fn(s, sc, x, y)
    return out


def _tiled_lanes(cfg, mesh: Mesh, interleave: bool):
    """The 8x128 tiled grid split over the mesh (packets interleaved)."""
    from raytracer_tpu_torch.schedule import _tiled_pixel_grid

    px, py, inv = _tiled_pixel_grid(cfg)
    if px.shape[0] % mesh.size:
        raise ValueError(f"tile-lane count {px.shape[0]} not divisible by mesh size {mesh.size}")
    unperm = None
    if interleave:
        px, py, unperm = _interleave_packets(px, py, mesh.size)
    return px, py, unperm, inv


def _assemble(rgb, unperm, inv, cfg, home):
    if unperm is not None:
        rgb = rgb[unperm.to(home)]
    return rgb[inv.to(home)].reshape(cfg.height, cfg.width, 3)


@torch.no_grad()
def render_image_sharded(scene, cam, cfg, key, mesh: Mesh | None = None,
                         spp: int | None = None) -> torch.Tensor:
    """Full-image render through the differentiable renderer
    (render.render_pixels) with the pixel axis sharded over the mesh →
    f32[H,W,3] on mesh.home (every rank's, under a process group)."""
    mesh = make_mesh() if mesh is None else mesh
    px, py, n = _padded_pixel_grid(cfg, mesh.size)
    parts = _per_shard(_shard_lanes(mesh, scene, px, py),
                       lambda s, sc, x, y: render_pixels(sc, cam, x, y, cfg, key, spp=spp))
    return mesh.gather(parts)[:n].reshape(cfg.height, cfg.width, 3)


@torch.no_grad()
def render_image_wavefront_sharded(scene, cam, cfg, key, mesh: Mesh | None = None,
                                   spp: int | None = None, interleave: bool = True) -> torch.Tensor:
    """Full-image wavefront render (models/wavefront.py) sharded over the
    mesh, lanes in 8x128 screen tiles; `interleave` deals the 1024-lane
    packets to the shards round-robin. Each shard runs its own drain, so
    the frame ends at the slowest (render_image_wavefront_rebalanced
    pools the tails)."""
    from raytracer_tpu_torch.models.wavefront import render_pixels_wavefront
    from raytracer_tpu_torch.render import mean_over_passes

    mesh = make_mesh() if mesh is None else mesh
    spp = cfg.spp if spp is None else int(spp)
    px, py, unperm, inv = _tiled_lanes(cfg, mesh, interleave)
    parts = _per_shard(_shard_lanes(mesh, scene, px, py), lambda s, sc, x, y: mean_over_passes(
        cfg, spp, lambda k, done: render_pixels_wavefront(sc, cam, x, y, cfg, key, spp=k,
                                                          sample_offset=done)))
    return _assemble(mesh.gather(parts), unperm, inv, cfg, mesh.home)


@torch.no_grad()
def render_image_wavefront_rebalanced(scene, cam, cfg, key, mesh: Mesh | None = None,
                                      spp: int | None = None, interleave: bool = True,
                                      rebalance_div: int = 8, report_iters: bool = False):
    """Sharded wavefront render with the cross-shard drain rebalance
    (models/wavefront.render_pixels_wavefront_rebalanced): once a
    shard's pending lanes fall to n_local // rebalance_div, the pending
    lanes of every shard are pooled and re-striped. Bit for bit the
    unsharded wavefront. With report_iters=True also returns the
    post-rebalance drain iterations of each shard, int32[S] (summed over
    the spp passes): their max/mean is the balance."""
    from raytracer_tpu_torch.models.wavefront import render_pixels_wavefront_rebalanced
    from raytracer_tpu_torch.render import spp_passes

    mesh = make_mesh() if mesh is None else mesh
    spp = cfg.spp if spp is None else int(spp)
    px, py, unperm, inv = _tiled_lanes(cfg, mesh, interleave)
    lanes = {s: (sc, cam, x, y) for s, (sc, x, y) in _shard_lanes(mesh, scene, px, py).items()}
    parts, iters = {}, {s: 0 for s in lanes}
    for k, done, w in spp_passes(cfg, spp):
        rgb, it = render_pixels_wavefront_rebalanced(
            lanes, cfg, key, mesh.all_gather, mesh.size, spp=k, sample_offset=done,
            rebalance_div=rebalance_div)
        for s in lanes:
            part = rgb[s] if w is None else rgb[s] * w
            parts[s] = part if s not in parts else parts[s] + part
            iters[s] += it[s]
    img = _assemble(mesh.gather(parts), unperm, inv, cfg, mesh.home)
    if not report_iters:
        return img
    counts = mesh.gather({s: torch.tensor([v], dtype=torch.int32, device=mesh.devices[s])
                          for s, v in iters.items()})
    return img, counts.cpu()


@torch.no_grad()
def render_image_fused_sharded(scene, cam, cfg, seed: int, mesh: Mesh | None = None,
                               spp: int | None = None, interleave: bool = True,
                               kernel_interleave: int | None = None) -> torch.Tensor:
    """Full-image render through the fused path loop (K3, or K5 with
    kernel_interleave=2 or RAYTRACER_TPU_INTERLEAVE=2; the plain version
    on CPU tensors) sharded over the mesh: one launch per shard per spp
    pass, lanes in 8x128 screen tiles, the packets dealt round-robin
    (`interleave`). Each shard takes a whole number of 1024-lane
    packets. Bit for bit models/fused.render_image_fused (the kernels
    work per lane, so the lane order does not change a pixel)."""
    from raytracer_tpu_torch.models.fused import fused_available, fused_lanes
    from raytracer_tpu_torch.schedule import _tiled_pixel_grid

    mesh = make_mesh() if mesh is None else mesh
    g = _tiled_pixel_grid(cfg)[0].shape[0] // PACKET
    if g % mesh.size:
        raise ValueError(f"packet count {g} not divisible by mesh size {mesh.size}")
    if not fused_available(scene, cfg):
        raise ValueError("scene exceeds the fused-kernel budgets (see ops/cuda_megakernel.py)")
    px, py, unperm, inv = _tiled_lanes(cfg, mesh, interleave)
    parts = _per_shard(_shard_lanes(mesh, scene, px, py), lambda s, sc, x, y: fused_lanes(
        sc, cam, cfg, seed, x, y, spp, interleave=kernel_interleave))
    return _assemble(mesh.gather(parts), unperm, inv, cfg, mesh.home)


@torch.no_grad()
def render_image_sharded_2d(scene, cam, cfg, key, mesh: Mesh, spp: int | None = None,
                            integrator: str = "megakernel") -> torch.Tensor:
    """Full-image render over a 2D (rays × spp) mesh: pixel blocks over
    `rays`, the samples in contiguous windows over `spp` (window j draws
    samples [j·k, (j+1)·k), k = spp // n_spp, through sample_offset), the
    windows' means averaged (the JAX package's pmean). Equal to the
    single-device render up to the order of the sums. `integrator`:
    "megakernel" (render.render_pixels) or "wavefront". spp must divide
    by the spp-axis size."""
    from raytracer_tpu_torch.models.wavefront import render_pixels_wavefront

    spp = cfg.spp if spp is None else int(spp)
    n_spp, n_ray = mesh.shape[SPP_AXIS], mesh.shape[RAY_AXIS]
    if spp % n_spp:
        raise ValueError(f"spp={spp} not divisible by spp-axis size {n_spp}")
    if integrator not in ("megakernel", "wavefront"):
        raise ValueError(f"render_image_sharded_2d: unknown integrator {integrator!r}")
    k = spp // n_spp
    if integrator == "wavefront":
        from raytracer_tpu_torch.schedule import _tiled_pixel_grid

        px, py, inv = _tiled_pixel_grid(cfg)
        if px.shape[0] % n_ray:
            raise ValueError(f"tile-lane count {px.shape[0]} not divisible by ray-axis size "
                             f"{n_ray}")
        render = render_pixels_wavefront
    else:
        px, py, n = _padded_pixel_grid(cfg, n_ray)
        render = render_pixels
    parts = _per_shard(_shard_lanes(mesh, scene, px, py, n_ray), lambda s, sc, x, y: render(
        sc, cam, x, y, cfg, key, spp=k, sample_offset=(s % n_spp) * k))
    every = mesh.gather(parts).reshape(n_ray, n_spp, -1, 3)
    total = every[:, 0]
    for j in range(1, n_spp):
        total = total + every[:, j]
    rgb = (total / float(n_spp)).reshape(-1, 3)
    if integrator == "wavefront":
        return rgb[inv.to(mesh.home)].reshape(cfg.height, cfg.width, 3)
    return rgb[:n].reshape(cfg.height, cfg.width, 3)
