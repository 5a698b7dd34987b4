"""Pixel-lane layouts for the fused path loop (port of the lane layouts
in raytracer_tpu/schedule.py and raytracer_tpu/models/wavefront.py).

Both are pure relabelings of pixels to lanes: draws are keyed by pixel,
so the assembled image does not depend on the layout. The layout only
groups neighbouring pixels into neighbouring lanes, so that the threads
of a warp trace coherent rays. Each returns (px, py, inv) with py
bottom-up and image.flat[p] = lanes[inv[p]]; frames that do not divide
into the blocks are padded with duplicated edge pixels, whose lanes
render but are dropped by `inv` (the first lane of a pixel wins).

The profile-guided reordering of raytracer_tpu/schedule.py is a recorded
dead end there and is not ported.
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
