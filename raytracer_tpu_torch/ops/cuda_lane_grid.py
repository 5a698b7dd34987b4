"""The lane layout (px, py, inv) built on its device: one launch of the
lane-grid kernel (csrc/lane_grid.cu) on a card, its plain PyTorch version
on the CPU or wherever `plain=True` asks for it.

`lane_grid(cfg, device)` is models/fused._fused_pixel_grid's layout and
`tiled_lane_grid(cfg, device)` schedule._tiled_pixel_grid's, bit for bit
and dtypes included: px, py int32 per lane (py bottom-up, padded lanes
clamped to the frame), inv int64 per pixel with image.flat[p] =
lanes[inv[p]]. Those numpy builders stay as the reference the tests hold
both versions to; they still serve the layouts that are permuted on the
host (schedule.build_schedule, parallel/sharding).

One closed form covers both layouts: lanes run over pkt_w x pkt_h packets
of the padded frame, inside a packet over its sub_w x sub_h sub-blocks,
inside a sub-block row by row (csrc/lane_grid.cu gives the map and why a
pixel's own lane comes before its padded duplicates, so that no scatter
is needed for "the first lane of a pixel wins").
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.schedule import PACKET
from raytracer_tpu_torch.utils import cudalib, profiling

# (pkt_w, pkt_h, sub_w, sub_h) of the two layouts in use.
BLOCKED = (32, 32, 8, 16)   # models/fused._fused_pixel_grid on frames that divide by 32
TILED = (128, 8, 128, 8)    # 8x128 screen tiles: one sub-block a packet
LAUNCHES = profiling.group("launch", ("lane_grid",))
PLAIN_CALLS = profiling.group("plain", ("lane_grid",))
_kernel = None   # rt_lane_grid, bound at the first launch


def fused_layout(cfg) -> tuple:
    """The fused path loop's layout, the one rule that models/fused and
    this module share: 32x32-pixel packets of 8(w)x16(h) sub-blocks on
    frames that divide into them, the 8x128 screen tiles otherwise, where
    32x32 padding would inflate the lane count."""
    return BLOCKED if cfg.width % 32 == 0 and cfg.height % 32 == 0 else TILED


def lane_grid(cfg, device, plain: bool = False):
    """models/fused._fused_pixel_grid's (px, py, inv), built on `device`."""
    return build(cfg.width, cfg.height, fused_layout(cfg), device, plain)


def tiled_lane_grid(cfg, device, plain: bool = False):
    """schedule._tiled_pixel_grid's (px, py, inv), built on `device`."""
    return build(cfg.width, cfg.height, TILED, device, plain)


def _padded(w: int, h: int, layout) -> tuple[int, int]:
    pkt_w, pkt_h, sub_w, sub_h = layout
    if not (min(w, h, sub_w, sub_h) >= 1 and pkt_w * pkt_h == PACKET and pkt_w % sub_w == 0
            and pkt_h % sub_h == 0):
        raise ValueError(f"lane grid: a {w}x{h} frame in {pkt_w}x{pkt_h} packets of "
                         f"{sub_w}x{sub_h} sub-blocks")
    return -(-w // pkt_w) * pkt_w, -(-h // pkt_h) * pkt_h


def build(w: int, h: int, layout, device, plain: bool = False):
    """(px, py, inv) of a w x h frame in `layout` on `device`: the kernel on
    a card, the plain version on the CPU or with `plain=True`."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"lane grid: unsupported device {device}")
    if plain or device.type == "cpu":
        return lane_grid_plain(w, h, layout, device)
    wp, hp = _padded(w, h, layout)
    global _kernel
    if _kernel is None:
        _kernel = cudalib.lib().rt_lane_grid
    px = torch.empty(wp * hp, dtype=torch.int32, device=device)
    py = px.new_empty(wp * hp)
    inv = px.new_empty(w * h, dtype=torch.int64)
    with cudalib.device_scope(device):
        code = _kernel(w, h, *layout, px.data_ptr(), py.data_ptr(), inv.data_ptr(),
                       cudalib.stream_handle())
    if code:
        cudalib.check(code, "lane-grid kernel")
    LAUNCHES.count("lane_grid")
    return px, py, inv


def lane_grid_plain(w: int, h: int, layout, device="cpu"):
    """The kernel's closed form in plain PyTorch, on `device`."""
    PLAIN_CALLS.count("lane_grid")
    wp, hp = _padded(w, h, layout)
    pkt_w, pkt_h, sub_w, sub_h = layout
    pkt_n, sub_n, npx, nsx = pkt_w * pkt_h, sub_w * sub_h, wp // pkt_w, pkt_w // sub_w
    i = torch.arange(wp * hp, dtype=torch.int64, device=device)
    p, k = i // pkt_n, i % pkt_n
    s, j = k // sub_n, k % sub_n
    row = (p // npx) * pkt_h + (s // nsx) * sub_h + j // sub_w
    col = (p % npx) * pkt_w + (s % nsx) * sub_w + j % sub_w
    px = col.clamp_max(w - 1).to(torch.int32)
    py = (h - 1 - row.clamp_max(h - 1)).to(torch.int32)
    q = torch.arange(w * h, dtype=torch.int64, device=device)
    r, c = q // w, q % w
    packet = (r // pkt_h) * npx + c // pkt_w
    sub = ((r % pkt_h) // sub_h) * nsx + (c % pkt_w) // sub_w
    inv = packet * pkt_n + sub * sub_n + (r % sub_h) * sub_w + c % sub_w
    return px, py, inv
