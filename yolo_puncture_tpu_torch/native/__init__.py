"""Host code in C++, built with g++ at first use into ``build/native/`` and
loaded with ctypes by ``_build.load``.  A failed build raises: there is no
fallback.

  * ``native/geometry.cpp``: ``ops/geometry.py`` calls ``min_area_rect``,
    ``trace_contours`` and ``rle_encode``; the numpy versions there are their
    plain versions;
  * ``native/png.cpp``: ``png_unfilter``, the PNG row filters undone for
    ``utils/png.py decode_png``.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from yolo_puncture_tpu_torch import _build

_lib = None
_png_lib = None


def load() -> ctypes.CDLL:
    """The loaded library with its signatures declared, built on first use."""
    global _lib
    if _lib is None:
        lib = _build.load("geometry")
        lib.min_area_rect.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.min_area_rect.restype = ctypes.c_int
        lib.trace_contours.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p]
        lib.trace_contours.restype = ctypes.c_int64
        lib.rle_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.rle_encode.restype = ctypes.c_int64
        _lib = lib
    return _lib


def min_area_rect(points: np.ndarray) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """(N, 2) points → ((cx, cy), (w, h), angle in degrees)."""
    pts = np.ascontiguousarray(np.asarray(points, dtype=np.float64).reshape(-1, 2))
    out = np.zeros(5, np.float64)
    load().min_area_rect(pts.ctypes.data, len(pts), out.ctypes.data)
    return (float(out[0]), float(out[1])), (float(out[2]), float(out[3])), float(out[4])


def trace_contours(mask: np.ndarray, largest_only: bool = False) -> List[np.ndarray]:
    """Outer contours of a binary mask as float32 (x, y) polygons, cv2's
    (RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) in cv2's order; with ``largest_only`` a
    list of the one with the most points (or an empty list)."""
    m = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    h, w = m.shape
    lib = load()
    cap_pts, cap_polys = 4096, 256
    while True:
        xy = np.empty((cap_pts, 2), np.int32)
        lens = np.empty(cap_polys, np.int64)
        n = ctypes.c_int64(0)
        total = lib.trace_contours(m.ctypes.data, h, w, int(largest_only), xy.ctypes.data, cap_pts,
                                   lens.ctypes.data, cap_polys, ctypes.byref(n))
        if total < 0:
            raise RuntimeError("trace_contours: a border walk did not close")
        if total <= cap_pts and n.value <= cap_polys:
            break
        cap_pts, cap_polys = max(cap_pts, int(total)), max(cap_polys, n.value)
    ends = np.cumsum(lens[:n.value])
    return [xy[e - k:e].astype(np.float32) for e, k in zip(ends, lens[:n.value])]


def rle_encode(mask: np.ndarray) -> list:
    """Runs of the nonzero pixels, row-major: [start, length, …], starts 1-based."""
    m = np.ascontiguousarray(np.asarray(mask).reshape(-1) != 0, dtype=np.uint8)
    out = np.empty(2 * (m.size // 2 + 1), np.int64)
    count = load().rle_encode(m.ctypes.data, m.size, out.ctypes.data)
    return out[:2 * count].tolist()


def png_unfilter(data: bytes, h: int, stride: int, bpp: int):
    """The ``h`` filtered rows of a PNG image (each a filter-type byte and
    ``stride`` bytes, ``bpp`` bytes a pixel) → (h, stride) uint8, or None where
    a row names a filter type other than 0..4."""
    global _png_lib
    if _png_lib is None:
        lib = _build.load("png")
        lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_void_p]
        lib.png_unfilter.restype = ctypes.c_int
        _png_lib = lib
    if len(data) < h * (stride + 1):
        raise ValueError(f"{len(data)} bytes hold fewer than {h} rows of {stride + 1}")
    out = np.empty((h, stride), np.uint8)
    if _png_lib.png_unfilter(bytes(data), h, stride, bpp, out.ctypes.data) != 0:
        return None
    return out
