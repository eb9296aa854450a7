"""Host-side mask contours for ``Masks.xy``.

Counterpart of ``mask_to_polygons`` in ``yolo_puncture_tpu/ops/geometry.py``:
``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`` when cv2 is installed,
else a numpy/scipy border tracer that gives the same polygons, in the same
order.  (The JAX package's own fallback tracer starts its walk the wrong way
round and returns a 2×2 loop for a filled square; the port does not copy it.)
The rest of that module arrives with a later slice.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2  # host-only; contours use it when present

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


def mask_to_polygons(binary_mask: np.ndarray, largest_only: bool = False):
    """Outer contours of a binary mask as float32 (x, y) polygons."""
    m = (np.asarray(binary_mask) > 0).astype(np.uint8)
    if _HAS_CV2:
        contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        polys = [c.reshape(-1, 2).astype(np.float32) for c in contours]
    else:
        polys = _trace_contours_np(m)
    if not polys:
        return [] if not largest_only else np.zeros((0, 2), np.float32)
    if largest_only:
        return max(polys, key=len)
    return polys


# (dy, dx) counter-clockwise on screen: E, NE, N, NW, W, SW, S, SE
_CCW = [(0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1)]


def _trace_contours_np(m: np.ndarray):
    """cv2's RETR_EXTERNAL / CHAIN_APPROX_SIMPLE contours without cv2.

    Foreground is 8-connected.  A component is external when it touches the
    background that reaches the frame's edge (4-connected), so components
    inside another's hole are left out.  Each border is walked counter-clockwise
    (Moore neighbours) from its first pixel in raster order until the first
    step repeats (Jacob's stop); straight runs keep only their end points.
    Polygons come in the reverse of raster order, as cv2 returns them."""
    from scipy import ndimage

    fg = np.asarray(m) > 0
    labeled, n = ndimage.label(fg, structure=np.ones((3, 3), bool))
    if n == 0:
        return []
    cross = ndimage.generate_binary_structure(2, 1)
    bg, _ = ndimage.label(np.pad(~fg, 1, constant_values=True), structure=cross)
    outside = ndimage.binary_dilation(bg == bg[0, 0], structure=cross)[1:-1, 1:-1]
    external = set(np.unique(labeled[outside & fg]).tolist())

    polys = []
    for lab, sl in enumerate(ndimage.find_objects(labeled), 1):
        if lab not in external:
            continue
        comp = np.pad(labeled[sl] == lab, 1)  # the padding spares bounds checks

        def step(cur, d):
            """First pixel of the component counter-clockwise from d - 2."""
            for i in range(8):
                nd = (d + 6 + i) % 8
                y, x = cur[0] + _CCW[nd][0], cur[1] + _CCW[nd][1]
                if comp[y, x]:
                    return (y, x), nd
            return None, d

        ys, xs = np.nonzero(comp)
        start = (int(ys[0]), int(xs[0]))
        cur, d, second, pts = start, 6, None, []  # d = 6: the first search begins west
        while True:
            nxt, d = step(cur, d)
            if nxt is None:  # a lone pixel
                pts.append(cur)
                break
            if cur == start and nxt == second:
                break
            pts.append(cur)
            second = nxt if second is None else second
            cur = nxt
        p = np.array(pts)
        if len(p) > 2:  # drop points inside straight (incl. diagonal) runs
            p = p[np.any(np.roll(p, -1, 0) - p != p - np.roll(p, 1, 0), axis=1)]
        p = p + (sl[0].start - 1, sl[1].start - 1)
        polys.append(p[:, ::-1].astype(np.float32))
    return polys[::-1]
