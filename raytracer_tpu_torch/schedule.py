"""Pixel-lane layouts for the fused path loop (port of
raytracer_tpu/schedule.py and the lane layout of
raytracer_tpu/models/wavefront.py).

Every layout is a pure relabeling of pixels to lanes: draws are keyed by
pixel, so the assembled image does not depend on the layout. A layout
only decides which pixels share a warp and a 1024-lane packet. Each
returns (px, py, inv) with py bottom-up and image.flat[p] = lanes[inv[p]];
frames that do not divide into the blocks are padded with duplicated
edge pixels, whose lanes render but are dropped by `inv` (the first lane
of a pixel wins).

`blocked_pixel_grid` and `_tiled_pixel_grid` group neighbouring pixels,
so that the threads of a warp trace coherent rays. The profile-guided
schedule (`build_schedule`) renders once through K3-profile and orders
the pixels by (cost-quantile bucket, Morton code), so that lanes of like
cost share a packet and stay local within it. On the TPU it recovered
≤2% (SCHEDULE_STUDY.json), where a packet locksteps 8 sub-warp chains;
on the H100 the warp is the lockstep unit and the hardware schedules
warps, so the question is open there (PERF.md). The numpy steps are the
JAX module's, so the same cost gives the same permutation bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

PACKET = 1024
LANE_ROW = 128


def _finish(lane_rows, lane_cols, w, h):
    n = lane_rows.size
    flat = lane_rows * w + lane_cols
    inv = np.zeros(h * w, np.int64)
    inv[flat[::-1]] = np.arange(n, dtype=np.int64)[::-1]  # first lane wins
    px = torch.from_numpy(lane_cols.astype(np.int32))
    py = torch.from_numpy((h - 1 - lane_rows).astype(np.int32))
    return px, py, torch.from_numpy(inv)


def _morton2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Interleave 16-bit x (low) and y bits → 32-bit Morton code."""
    def part(v):
        v = v.astype(np.int64)
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return part(x) | (part(y) << 1)


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _device(x):
    return x.device if torch.is_tensor(x) else torch.device("cpu")


def order_by_cost(px, py, cost, cfg, n_buckets: int = 32):
    """Reorder lanes by (cost bucket, Morton) (raytracer_tpu/schedule.py:69):
    px/py/cost are the current lane arrays (length N, N % 1024 == 0).
    Returns (px2, py2, inv) on px's device, where image.flat[p] =
    render_lanes[inv[p]] (first lane wins on padding duplicates)."""
    dev = _device(px)
    px, py = _numpy(px), _numpy(py)
    cost = _numpy(cost).astype(np.float64)
    n = px.shape[0]
    if n_buckets > 1:
        qs = np.quantile(cost, np.linspace(0, 1, n_buckets + 1)[1:-1])
        bucket = np.searchsorted(qs, cost)
    else:
        bucket = np.zeros(n, np.int64)
    mort = _morton2(px, (cfg.height - 1 - py))  # top-down y for locality
    order = np.lexsort((mort, bucket))
    px2 = px[order]
    py2 = py[order]
    w, h = cfg.width, cfg.height
    flat = (h - 1 - py2) * w + px2
    inv = np.zeros(h * w, np.int64)
    inv[flat[::-1]] = np.arange(n, dtype=np.int64)[::-1]
    return (torch.from_numpy(px2.astype(np.int32)).to(dev),
            torch.from_numpy(py2.astype(np.int32)).to(dev), torch.from_numpy(inv).to(dev))


def order_by_row_cost(px, py, cost):
    """Regroup whole 128-lane rows by their mean cost
    (raytracer_tpu/schedule.py:96): rows keep their content, only which
    8 rows share a packet changes. Returns (px2, py2, order) on px's
    device, order the new row order."""
    dev = _device(px)
    px, py = _numpy(px), _numpy(py)
    n = px.shape[0]
    rows = n // LANE_ROW
    row_cost = _numpy(cost).astype(np.float64).reshape(rows, LANE_ROW).mean(axis=1)
    order = np.argsort(row_cost, kind="stable")
    lane_order = (order[:, None] * LANE_ROW + np.arange(LANE_ROW)[None, :]).reshape(-1)
    return (torch.from_numpy(px[lane_order]).to(dev), torch.from_numpy(py[lane_order]).to(dev),
            torch.from_numpy(order).to(dev))


def build_schedule(scene, cam, cfg, seed: int, profile_spp: int = 2, n_buckets: int = 32):
    """One instrumented render (K3-profile on the card, its plain version
    on the CPU) → (px, py, inv) lane order for render_tiles_fused, on the
    scene's device (raytracer_tpu/schedule.py:161). Only the relative
    cost ranking matters, so a low-spp profile suffices."""
    from raytracer_tpu_torch.ops.cuda_megakernel import render_tiles_fused

    dev = scene.materials.type.device
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    _, cost, _ = render_tiles_fused(scene, cam, cfg, seed, px, py, spp=profile_spp,
                                    profile=True, interleave=1)
    return order_by_cost(px, py, cost, cfg, n_buckets=n_buckets)


def blocked_pixel_grid(cfg, pkt_w: int, pkt_h: int, sub_w: int, sub_h: int):
    """Lanes where each 1024-lane packet covers a pkt_w × pkt_h screen
    block and each 128-lane group a sub_w × sub_h sub-block
    (raytracer_tpu/schedule.py:116)."""
    if not (pkt_w * pkt_h == PACKET and sub_w * sub_h == LANE_ROW
            and pkt_w % sub_w == 0 and pkt_h % sub_h == 0):
        raise ValueError(f"blocked_pixel_grid: {pkt_w}x{pkt_h} packets of {sub_w}x{sub_h} "
                         f"sub-blocks must hold {PACKET} and {LANE_ROW} lanes")
    w, h = cfg.width, cfg.height
    wp = (w + pkt_w - 1) // pkt_w * pkt_w
    hp = (h + pkt_h - 1) // pkt_h * pkt_h
    rows = np.minimum(np.arange(hp), h - 1)
    cols = np.minimum(np.arange(wp), w - 1)
    r2 = np.broadcast_to(rows[:, None], (hp, wp))
    c2 = np.broadcast_to(cols[None, :], (hp, wp))

    def lanes(a):
        a4 = a.reshape(hp // pkt_h, pkt_h, wp // pkt_w, pkt_w)
        a4 = a4.transpose(0, 2, 1, 3)  # [PBy, PBx, pkt_h, pkt_w]
        a6 = a4.reshape(hp // pkt_h, wp // pkt_w,
                        pkt_h // sub_h, sub_h, pkt_w // sub_w, sub_w)
        return a6.transpose(0, 1, 2, 4, 3, 5).reshape(-1)

    return _finish(lanes(r2), lanes(c2), w, h)


def _tiled_pixel_grid(cfg):
    """Lanes in 8x128 screen-tile order
    (raytracer_tpu/models/wavefront.py:416)."""
    th, tw = 8, 128
    w, h = cfg.width, cfg.height
    wp = (w + tw - 1) // tw * tw
    hp = (h + th - 1) // th * th
    rows = np.minimum(np.arange(hp), h - 1)
    cols = np.minimum(np.arange(wp), w - 1)
    r2 = np.broadcast_to(rows[:, None], (hp, wp))
    c2 = np.broadcast_to(cols[None, :], (hp, wp))
    lane_rows = r2.reshape(hp // th, th, wp // tw, tw).transpose(0, 2, 1, 3).reshape(-1)
    lane_cols = c2.reshape(hp // th, th, wp // tw, tw).transpose(0, 2, 1, 3).reshape(-1)
    return _finish(lane_rows, lane_cols, w, h)
