"""PNG files without cv2: a writer (8-bit RGB, no interlace) and a reader.

The port runs where cv2 is missing.  The tracker's saver and the web UI
write their images with ``encode_png_rgb`` where the JAX package calls
``cv2.imwrite``: every row is stored with filter type 0 and the image data
compressed with ``zlib``; a PNG reader gives back the same pixels as it does
for cv2's file.  The server, the web UI and the predictor read PNG files with
``decode_png`` where the JAX package calls ``cv2.imdecode`` / ``cv2.imread``:
it gives cv2's BGR pixels for 8-bit, non-interlaced gray, RGB and RGBA files,
whatever row filters the writer chose (``native/png.cpp`` undoes them).
``decode_image`` hands other formats to cv2 where it is installed.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

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


_CHANNELS = {0: 1, 2: 3, 6: 4}   # colour type → samples a pixel: gray, RGB, RGBA


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """The bytes of a PNG file → BGR uint8 (H, W, 3), the pixels of
    ``cv2.imdecode(..., cv2.IMREAD_COLOR)``: gray is spread over the three
    channels and alpha is dropped.  Reads 8-bit, non-interlaced files of colour
    type 0, 2 or 6; any other file, or bytes that are not a whole PNG file
    (a chunk cut short or with a wrong CRC, image data that does not inflate),
    give None, as ``cv2.imdecode`` gives for bytes it cannot read."""
    from yolo_puncture_tpu_torch import native

    b = bytes(data)
    if not b.startswith(_SIGNATURE):
        return None
    pos, header, idat = len(_SIGNATURE), None, []
    while True:
        if pos + 12 > len(b):
            return None                                   # no IEND
        n, kind = struct.unpack(">I4s", b[pos:pos + 8])
        body = b[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(b):
            return None
        if struct.unpack(">I", b[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            return None
        pos += 12 + n
        if kind == b"IHDR" and n == 13:
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        return None
    w, h, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS or compression or filtering or interlace or not (w and h):
        return None
    c = _CHANNELS[colour]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error:
        return None
    if len(raw) < h * (w * c + 1):
        return None
    rows = native.png_unfilter(raw, h, w * c, c)
    if rows is None:
        return None
    px = rows.reshape(h, w, c)
    if c == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])     # RGB(A) → BGR


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """Image bytes → BGR uint8 (H, W, 3), or None where they cannot be read: a
    PNG file through ``decode_png``, any other through ``cv2.imdecode`` where
    cv2 is installed."""
    frame = decode_png(data)
    if frame is not None or not data:
        return frame
    try:
        import cv2
    except ImportError:
        return None
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
