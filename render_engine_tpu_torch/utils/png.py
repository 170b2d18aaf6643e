"""Minimal dependency-free PNG writer for frame dumps."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def encode_png(rgb: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode an (H, W, 3) uint8 array as PNG bytes."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data))
        )

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, compress_level))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as a PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))
