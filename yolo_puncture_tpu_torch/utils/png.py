"""A PNG writer on the standard library: 8-bit RGB, no interlace.

The tracker's saver writes its id-mask images with it where the JAX package
calls ``cv2.imwrite``: the machine with the card has no cv2.  Every row is
stored with filter type 0 and the image data compressed with ``zlib``; a PNG
reader gives back the same pixels as it does for cv2's file.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png_rgb(rgb: np.ndarray, level: int = 1) -> bytes:
    """(H, W, 3) uint8 RGB → the bytes of a PNG file, compressed at zlib
    ``level`` (1, cv2's default for PNG)."""
    a = np.ascontiguousarray(rgb)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"encode_png_rgb takes an (H, W, 3) uint8 image, got {a.shape} {a.dtype}")
    h, w, _ = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, 3 * w)], axis=1)  # filter byte 0 a row
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # depth 8, colour type 2 (RGB), no interlace
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png_rgb(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB to ``path`` as a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png_rgb(rgb))
