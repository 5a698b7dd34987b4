"""Image output (port of raytracer_tpu/utils/image.py): PNG through a
pure zlib encoder, and NPY. Images are row-0-top."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, rgba: np.ndarray) -> None:
    """Write u8[H,W,3|4] to a PNG file."""
    arr = np.asarray(rgba)
    if arr.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    h, w, c = arr.shape
    color_type = {3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def write_npy(path: str, arr) -> None:
    np.save(path, np.asarray(arr))
