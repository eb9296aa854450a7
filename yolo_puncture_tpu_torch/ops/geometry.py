"""Host-side mask geometry: contours, the min-area rectangle, fills and encodings.

Counterpart of ``yolo_puncture_tpu/ops/geometry.py``:
  * ``mask_to_polygons``: ``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``
    when cv2 is installed, else the C++ border tracer of ``native/geometry.cpp``
    that gives the same polygons, in the same order, and keeps cv2's choice of
    the largest (the most points).  ``_trace_contours_np`` is its plain numpy
    version.  (The JAX package's own fallback tracers differ: its numpy one
    starts its walk the wrong way round and returns a 2×2 loop for a filled
    square, its C++ one keeps the component with the most border pixels; the
    port copies neither.)
  * ``min_rect_len`` / ``min_rect_len_mask``: the long side and aspect ratio of
    the minimum-area rotated rectangle (convex hull + rotating calipers) in C++
    (``native``), with ``_min_area_rect_np`` its plain numpy version;
  * polygon fill, binary-mask overlay, RLE (C++, ``_rle_encoding_np`` the plain
    version) and polygon encodings, the ROI box overlay and the SAM-mask
    ranking filter.  Where cv2 is missing, drawing
    takes the JAX package's numpy branches.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from yolo_puncture_tpu_torch import native

try:
    import cv2  # host-only; contours and drawing use it when present

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
        polys = native.trace_contours(m, largest_only)
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


# ---------------------------------------------------------------------------
# Convex hull + rotating calipers
# ---------------------------------------------------------------------------

def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain.  points (N, 2) → hull vertices counter-clockwise (M, 2)."""
    pts = np.unique(points.astype(np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]  # by x, then y

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(iterable):
        out: List[np.ndarray] = []
        for p in iterable:
            while len(out) >= 2 and cross2(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def min_area_rect(points: np.ndarray) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """Minimum-area enclosing rotated rectangle as ((cx, cy), (w, h), angle_deg),
    the structure ``cv2.minAreaRect`` returns: ``native.min_area_rect``, the C++
    form of ``_min_area_rect_np``."""
    return native.min_area_rect(points)


def _min_area_rect_np(points: np.ndarray) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """Plain numpy version of ``min_area_rect``.  The optimal rectangle has a
    side collinear with a hull edge, so every edge angle (mod 90°) is tried at
    once; the first least area wins."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    hull = convex_hull(pts)
    if len(hull) == 0:
        return ((0.0, 0.0), (0.0, 0.0), 0.0)
    if len(hull) == 1:
        return ((float(hull[0, 0]), float(hull[0, 1])), (0.0, 0.0), 0.0)
    if len(hull) == 2:
        d = hull[1] - hull[0]
        c = hull.mean(axis=0)
        return ((float(c[0]), float(c[1])), (float(np.hypot(*d)), 0.0),
                float(np.degrees(np.arctan2(d[1], d[0]))))

    edges = np.diff(np.vstack([hull, hull[:1]]), axis=0)
    angles = np.unique(np.arctan2(edges[:, 1], edges[:, 0]) % (np.pi / 2))
    cos, sin = np.cos(angles), np.sin(angles)
    R = np.stack([np.stack([cos, sin], -1), np.stack([-sin, cos], -1)], axis=1)  # rotate by -angle
    rot = R @ hull.T[None]  # (K, 2, M)
    mins, maxs = rot.min(axis=2), rot.max(axis=2)
    wh = maxs - mins
    k = int(np.argmin(wh[:, 0] * wh[:, 1]))
    w, h = wh[k]
    cx_r = (mins[k, 0] + maxs[k, 0]) / 2
    cy_r = (mins[k, 1] + maxs[k, 1]) / 2
    a = angles[k]
    cx = cx_r * np.cos(a) - cy_r * np.sin(a)
    cy = cx_r * np.sin(a) + cy_r * np.cos(a)
    return ((float(cx), float(cy)), (float(w), float(h)), float(np.degrees(a)))


def _long_side_and_aspect(points: np.ndarray) -> Tuple[float, float]:
    if len(points) < 3:
        return 0.0, 0.0
    (_, (w, h), _) = min_area_rect(points.astype(np.float64))
    length = max(w, h)
    width = min(w, h)
    if width == 0:
        width = 1
    return float(length), float(length / width)


def min_rect_len(coord_xy) -> Tuple[float, float]:
    """Long side and aspect ratio of a polygon's min-area rectangle; the points
    are truncated to int32 first, as the reference casts them.  < 3 points: (0, 0)."""
    return _long_side_and_aspect(np.asarray(coord_xy, dtype=np.int32).reshape(-1, 2))


def min_rect_len_mask(mask_bi: np.ndarray) -> Tuple[float, float]:
    """Long side and aspect ratio over a binary mask's foreground pixels (row, col)."""
    return _long_side_and_aspect(np.column_stack(np.where(mask_bi)).astype(np.int32))


# ---------------------------------------------------------------------------
# Fills and overlays
# ---------------------------------------------------------------------------

def polygon_to_mask(image_shape, mask_xy, color=(255, 255, 0)) -> np.ndarray:
    """Fill a polygon into a uint8 mask of ``image_shape``."""
    mask = np.zeros(image_shape, dtype=np.uint8)
    if mask_xy is None or len(mask_xy) == 0:
        return mask
    points = np.array(mask_xy, dtype=np.int32).reshape((-1, 1, 2))
    if _HAS_CV2:
        cv2.fillPoly(mask, [points], color)
        return mask
    return _fill_poly_np(mask, points.reshape(-1, 2), color)


def _fill_poly_np(mask, pts, color):
    """Scanline polygon fill (even-odd, both crossings inclusive)."""
    x0, y0 = pts[:, 0], pts[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    for y in range(mask.shape[0]):
        cond = ((y0 <= y) & (y1 > y)) | ((y1 <= y) & (y0 > y))
        if not cond.any():
            continue
        xs = x0[cond] + (y - y0[cond]) * (x1[cond] - x0[cond]) / np.maximum(y1[cond] - y0[cond], 1e-9)
        xs = np.sort(xs)
        for i in range(0, len(xs) - 1, 2):
            a, b = int(np.ceil(xs[i])), int(np.floor(xs[i + 1]))
            if b >= a:
                mask[y, a:b + 1] = color
    return mask


def binary_mask_overlay(img_shape, mask_bi, x_offset: int = 0, y_offset: int = 0,
                        color=(255, 255, 0)) -> np.ndarray:
    """Paint a binary mask's pixels, shifted by the offsets, into an RGB overlay."""
    mask = np.zeros(img_shape, dtype=np.uint8)
    if mask_bi is None or np.size(mask_bi) == 0:
        return mask
    y_idx, x_idx = np.nonzero(mask_bi)
    y_idx = np.clip(y_idx + y_offset, 0, img_shape[0] - 1)
    x_idx = np.clip(x_idx + x_offset, 0, img_shape[1] - 1)
    mask[y_idx, x_idx] = color
    return mask


def create_roi_mask(frame_shape, x1, y1, x2, y2, label: str) -> np.ndarray:
    """Blue ROI rectangle with its label, on a black frame-sized overlay."""
    height, width = frame_shape[0], frame_shape[1]
    mask = np.zeros((height, width, 3), dtype=np.uint8)
    color = (0, 0, 255)
    if _HAS_CV2:
        cv2.rectangle(mask, (int(x1), int(y1)), (int(x2), int(y2)), color, 2)
        if label:
            font = cv2.FONT_HERSHEY_COMPLEX
            text_size = cv2.getTextSize(label, font, 1, 2)[0]
            text_y = y1 - 10 if y1 - 10 > 10 else y1 + 10 + text_size[1]
            cv2.putText(mask, label, (int(x1), int(text_y)), font, 1, color, 2, cv2.LINE_AA)
    else:  # the rectangle only: no text without cv2
        x1, y1 = max(0, int(x1)), max(0, int(y1))
        x2, y2 = min(width - 1, int(x2)), min(height - 1, int(y2))
        mask[y1:y1 + 2, x1:x2] = color
        mask[y2 - 1:y2 + 1, x1:x2] = color
        mask[y1:y2, x1:x1 + 2] = color
        mask[y1:y2, x2 - 1:x2 + 1] = color
    return mask


# ---------------------------------------------------------------------------
# Encodings and the SAM-mask filter
# ---------------------------------------------------------------------------

def rle_encoding(binary_segment: np.ndarray) -> list:
    """Binary mask → run-length list [start, length, start, length, …] (1-based
    starts, row-major), in C++ (``native.rle_encode``)."""
    return native.rle_encode(binary_segment)


def _rle_encoding_np(binary_segment: np.ndarray) -> list:
    pixels = np.concatenate([[0], np.asarray(binary_segment).flatten(), [0]])
    runs = np.where(pixels[1:] != pixels[:-1])[0] + 1
    runs[1::2] -= runs[::2]
    return runs.tolist()


def polygon_encoding(binary_segment: np.ndarray, normalize: bool = True) -> list:
    """Binary mask → flat list of its contours' coordinates, normalised to [0, 1]
    and rounded to 6 places when ``normalize``."""
    seg = np.asarray(binary_segment).astype(np.uint8)
    h, w = seg.shape[:2]
    out: List[float] = []
    for contour in mask_to_polygons(seg):
        pts = [(float(x), float(y)) for x, y in contour]
        if normalize:
            pts = [(round(min(1.0, max(0.0, x / w)), 6), round(min(1.0, max(0.0, y / h)), 6)) for x, y in pts]
        out.extend([c for p in pts for c in p])
    return out


def filter_masks(masks: Sequence[dict], topn: int = 1) -> Optional[list]:
    """Rank SAM candidate masks (best first, ``topn`` of them): elongated ↑, near
    the crop's centre ↑, area in [300, 3000], straddling the vertical midline ↑."""
    if len(masks) == 0:
        return None
    crop_box = masks[0]["crop_box"]
    total_area = (crop_box[2] - crop_box[0]) * (crop_box[3] - crop_box[1])
    scores = [0.0] * len(masks)
    for idx, mask in enumerate(masks):
        bbox = mask["bbox"]  # xywh
        area = mask["area"]
        _, ratio = min_rect_len_mask(mask["segmentation"])
        scores[idx] += ratio
        distance = np.sqrt(
            ((bbox[0] + bbox[2] / 2) - ((crop_box[0] + crop_box[2]) / 2)) ** 2
            + ((bbox[1] + bbox[3] / 2) - ((crop_box[1] + crop_box[3]) / 2)) ** 2
        )
        scores[idx] += 2 * 1000 / max(distance, 1e-9)
        scores[idx] += 5 - area / total_area * 100
        if area < 300 or area > 3000:
            scores[idx] -= 100
        mid = (crop_box[0] + crop_box[2]) / 2
        if (bbox[0] < mid) and (bbox[0] + bbox[2] > mid):
            scores[idx] += 30
    return [masks[i] for i in np.argsort(scores)[-topn:]][::-1]
