"""Contours and result objects of the PyTorch port against the JAX package.

``Masks.xy`` takes the largest outer contour of each mask.  The JAX package
gets it from ``cv2.findContours``; the port does too where cv2 is installed,
and otherwise (as on a machine without cv2) from its C++ tracer
(``native/geometry.cpp``), which, like its plain numpy version, must give cv2's
polygons exactly, in cv2's order.  The Boxes / Masks accessors must give the
JAX package's arrays exactly.  The C++ calipers and RLE against their numpy
versions: rectangles within 1e-9 relative (products rounded in another order
than numpy's matmul), runs exactly.
"""

import numpy as np
import pytest
from scipy import ndimage

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from yolo_puncture_tpu.ops import geometry as jgeo
from yolo_puncture_tpu.predict import results as jres
from yolo_puncture_tpu_torch.ops import geometry as pgeo
from yolo_puncture_tpu_torch.predict import results as pres

pytestmark = pytest.mark.skipif(not jgeo._HAS_CV2, reason="the JAX package's contours need cv2")


def _masks(kind, seed, n=40):
    """Binary masks: speckle, smooth blobs, or overlapping rectangles (holes, nested
    islands, diagonal contacts, single pixels and frame-edge contact all occur)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        H, W = rng.integers(1, 30, 2)
        if kind == "speckle":
            m = rng.random((H, W)) < rng.uniform(0.1, 0.7)
        elif kind == "blobs":
            m = ndimage.zoom(rng.random((max(H // 4, 1), max(W // 4, 1))), 4, order=1)[:H, :W] > 0.5
        else:
            m = np.zeros((H, W), bool)
            for _ in range(4):
                y, x = rng.integers(0, H), rng.integers(0, W)
                m[y:y + rng.integers(1, 9), x:x + rng.integers(1, 9)] ^= True
        out.append(m.astype(np.uint8))
    return out


def _assert_same_polys(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("kind", ["speckle", "blobs", "rects"])
def test_numpy_tracer_gives_cv2_contours(kind, monkeypatch):
    ref = [jgeo.mask_to_polygons(m) for m in _masks(kind, seed=len(kind))]
    monkeypatch.setattr(pgeo, "_HAS_CV2", False)                # the C++ tracer
    for m, r in zip(_masks(kind, seed=len(kind)), ref):
        _assert_same_polys(pgeo.mask_to_polygons(m), r)
        _assert_same_polys(pgeo._trace_contours_np(m), r)


def test_numpy_tracer_on_a_filled_square():
    m = np.zeros((20, 20), np.uint8)
    m[5:15, 5:15] = 1
    np.testing.assert_array_equal(pgeo._trace_contours_np(m)[0], [[5, 5], [5, 14], [14, 14], [14, 5]])


@pytest.mark.parametrize("has_cv2", [True, False])
def test_mask_to_polygons_matches_jax(has_cv2, monkeypatch):
    monkeypatch.setattr(pgeo, "_HAS_CV2", has_cv2)
    for m in _masks("rects", seed=9, n=10):
        _assert_same_polys(pgeo.mask_to_polygons(m), jgeo.mask_to_polygons(m))
        np.testing.assert_array_equal(pgeo.mask_to_polygons(m, largest_only=True),
                                      jgeo.mask_to_polygons(m, largest_only=True))
    empty = np.zeros((6, 7), np.uint8)
    assert pgeo.mask_to_polygons(empty) == []
    assert pgeo.mask_to_polygons(empty, largest_only=True).shape == (0, 2)


def test_boxes_and_masks_accessors_match_jax():
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 40, (3, 2))
    xyxy = np.concatenate([xy, xy + rng.uniform(1, 15, (3, 2))], 1).astype(np.float32)
    conf, cls, shape = rng.uniform(0, 1, 3), np.array([0, 2, 1]), (40, 56)
    data = np.zeros((3, *shape), np.float32)
    for i, (x1, y1, x2, y2) in enumerate(xyxy.astype(int)):
        data[i, y1:y2, x1:x2] = 1.0
    got_b, ref_b = pres.Boxes(xyxy, conf, cls, shape), jres.Boxes(xyxy, conf, cls, shape)
    for attr in ("xyxy", "xywh", "xyxyn", "conf", "cls", "data"):
        np.testing.assert_array_equal(getattr(got_b, attr), getattr(ref_b, attr), err_msg=attr)
    got_m, ref_m = pres.Masks(data, shape), jres.Masks(data, shape)
    np.testing.assert_array_equal(got_m.data, ref_m.data)
    _assert_same_polys(got_m.xy, ref_m.xy)
    _assert_same_polys(got_m.xyn, ref_m.xyn)


# ---------------------------------------------------------------------------
# The min-area rectangle, fills and encodings
# ---------------------------------------------------------------------------

RECT_ATOL = 1e-9  # the JAX package takes its C++ calipers where built, the port numpy's


def _point_sets(seed, n=60):
    """Point clouds: float, integer, collinear, one or two points, duplicates."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(1, 40))
        pts = rng.uniform(-50, 200, (k, 2))
        if i % 3 == 1:
            pts = np.round(pts)
        if i % 7 == 2:
            pts = np.stack([np.linspace(0, 30, k), 2 * np.linspace(0, 30, k) + 1], -1)
        if i % 5 == 3:
            pts = np.concatenate([pts, pts[:3]])
        out.append(pts)
    return out


def test_convex_hull_and_min_area_rect_match_jax(monkeypatch):
    """The same rectangle as the JAX package's numpy calipers (the port's plain
    numpy version, ``_min_area_rect_np``; ``min_area_rect`` itself is C++, held
    to it in ``test_native_geometry_matches_the_numpy_versions``), and the same
    area as the JAX package's C++ calipers (where two hull edges give rectangles
    of equal area, the two may keep different ones: seed 11 has such a
    quadrilateral)."""
    import yolo_puncture_tpu.native as jnative

    native = [jgeo.min_area_rect(pts) for pts in _point_sets(11)]
    monkeypatch.setattr(jnative, "min_area_rect_native", lambda pts: None)
    for pts, nat in zip(_point_sets(11), native):
        np.testing.assert_array_equal(pgeo.convex_hull(pts), jgeo.convex_hull(pts))
        got = pgeo._min_area_rect_np(pts)
        assert got == jgeo.min_area_rect(pts)
        area, nat_area = got[1][0] * got[1][1], nat[1][0] * nat[1][1]
        assert abs(area - nat_area) <= RECT_ATOL * max(nat_area, 1.0)
    assert pgeo._min_area_rect_np(np.zeros((0, 2))) == ((0.0, 0.0), (0.0, 0.0), 0.0)
    assert pgeo.min_area_rect(np.zeros((0, 2))) == ((0.0, 0.0), (0.0, 0.0), 0.0)


@pytest.mark.parametrize("native", [True, False], ids=["jax-native", "jax-numpy"])
def test_min_rect_len_matches_jax(native, monkeypatch):
    """On fuzzed polygons (truncated to int first) and fuzzed masks, against the
    JAX package with its C++ calipers and with its numpy ones."""
    if not native:
        import yolo_puncture_tpu.native as jnative

        monkeypatch.setattr(jnative, "min_area_rect_native", lambda pts: None)
    for pts in _point_sets(12):
        np.testing.assert_allclose(pgeo.min_rect_len(pts), jgeo.min_rect_len(pts), rtol=0, atol=RECT_ATOL)
    for m in _masks("blobs", seed=13) + _masks("rects", seed=14):
        np.testing.assert_allclose(pgeo.min_rect_len_mask(m), jgeo.min_rect_len_mask(m), rtol=0, atol=RECT_ATOL)
    assert pgeo.min_rect_len([[1, 2], [3, 4]]) == (0.0, 0.0)


@pytest.mark.parametrize("has_cv2", [True, False])
def test_fills_and_overlays_match_jax(has_cv2, monkeypatch):
    monkeypatch.setattr(pgeo, "_HAS_CV2", has_cv2)
    monkeypatch.setattr(jgeo, "_HAS_CV2", has_cv2)
    rng = np.random.default_rng(15)
    for _ in range(20):
        poly = rng.uniform(-5, 45, (int(rng.integers(3, 9)), 2))
        np.testing.assert_array_equal(pgeo.polygon_to_mask((40, 50, 3), poly), jgeo.polygon_to_mask((40, 50, 3), poly))
        x1, y1 = rng.integers(0, 30, 2)
        x2, y2 = x1 + rng.integers(2, 25), y1 + rng.integers(2, 20)
        np.testing.assert_array_equal(pgeo.create_roi_mask((40, 50), x1, y1, x2, y2, "needle"),
                                      jgeo.create_roi_mask((40, 50), x1, y1, x2, y2, "needle"))
    assert not pgeo.polygon_to_mask((4, 5, 3), []).any()
    for m in _masks("speckle", seed=16, n=10):
        ox, oy = (int(v) for v in rng.integers(-3, 4, 2))
        np.testing.assert_array_equal(pgeo.binary_mask_overlay((32, 32, 3), m, ox, oy),
                                      jgeo.binary_mask_overlay((32, 32, 3), m, ox, oy))
    assert not pgeo.binary_mask_overlay((4, 4, 3), None).any()


def test_numpy_fill_matches_jax():
    rng = np.random.default_rng(17)
    for _ in range(20):
        pts = rng.integers(-5, 45, (int(rng.integers(3, 9)), 2)).astype(np.int32)
        got = pgeo._fill_poly_np(np.zeros((40, 50, 3), np.uint8), pts, (255, 255, 0))
        np.testing.assert_array_equal(got, jgeo._fill_poly_np(np.zeros((40, 50, 3), np.uint8), pts, (255, 255, 0)))


def test_encodings_and_mask_filter_match_jax():
    for m in _masks("rects", seed=18, n=20) + _masks("speckle", seed=19, n=10):
        assert pgeo.rle_encoding(m) == jgeo.rle_encoding(m) == jgeo._rle_encoding_np(m)
        assert pgeo._rle_encoding_np(m) == jgeo._rle_encoding_np(m)
        for normalize in (True, False):
            assert pgeo.polygon_encoding(m, normalize) == jgeo.polygon_encoding(m, normalize)
    rng = np.random.default_rng(20)
    masks = []
    for _ in range(6):
        seg = np.zeros((60, 80), bool)
        x, y = rng.integers(0, 60), rng.integers(0, 40)
        seg[y:y + rng.integers(2, 20), x:x + rng.integers(2, 20)] = True
        ys, xs = np.nonzero(seg)
        masks.append({"segmentation": seg, "area": int(seg.sum()), "crop_box": [0, 0, 80, 60],
                      "bbox": [int(xs.min()), int(ys.min()), int(np.ptp(xs)) + 1, int(np.ptp(ys)) + 1]})
    for topn in (1, 3):
        assert [id(m) for m in pgeo.filter_masks(masks, topn)] == [id(m) for m in jgeo.filter_masks(masks, topn)]
    assert pgeo.filter_masks([]) is None


NATIVE_RECT_RTOL = 1e-9


def _assert_same_rect(pts):
    """C++ calipers against numpy's: the same rectangle within NATIVE_RECT_RTOL;
    where two hull edges give rectangles of equal area (the two smallest
    candidates within NATIVE_RECT_RTOL of each other), either may be kept, as
    between the JAX package's two calipers, and the areas agree."""
    from yolo_puncture_tpu_torch import native

    got, ref = native.min_area_rect(pts), pgeo._min_area_rect_np(pts)
    hull = pgeo.convex_hull(np.asarray(pts, np.float64))
    areas = []
    if len(hull) >= 3:
        edges = np.diff(np.vstack([hull, hull[:1]]), axis=0)
        for a in np.unique(np.arctan2(edges[:, 1], edges[:, 0]) % (np.pi / 2)):
            r = np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]]) @ hull.T
            areas.append(np.prod(r.max(1) - r.min(1)))
    areas = np.sort(areas)
    tied = len(areas) > 1 and areas[1] - areas[0] <= NATIVE_RECT_RTOL * max(areas[0], 1.0)
    if tied:
        assert abs(got[1][0] * got[1][1] - areas[0]) <= NATIVE_RECT_RTOL * max(areas[0], 1.0)
        return
    np.testing.assert_allclose(np.hstack(got[:2] + (got[2],)), np.hstack(ref[:2] + (ref[2],)),
                               rtol=NATIVE_RECT_RTOL, atol=NATIVE_RECT_RTOL)


def test_native_geometry_matches_the_numpy_versions(monkeypatch):
    """``native/geometry.cpp`` on fuzzed masks, small and 240×320: the contours
    equal the numpy tracer's (0 differing points) and cv2's; the largest-only pick
    is cv2's (the polygon with the most points, the first of equals in cv2's
    order); the calipers as ``_assert_same_rect`` says, on the polygons, on the
    masks' pixels and on fuzzed point sets; RLE equal."""
    import cv2

    from yolo_puncture_tpu_torch import native

    rng = np.random.default_rng(21)
    big = [ndimage.zoom(rng.random((24, 32)), 10, order=1) > t for t in (0.45, 0.55, 0.65)]
    masks = _masks("speckle", 31) + _masks("blobs", 32) + _masks("rects", 33) + [b.astype(np.uint8) for b in big]
    monkeypatch.setattr(pgeo, "_HAS_CV2", False)
    for m in masks:
        polys = native.trace_contours(m)
        _assert_same_polys(polys, pgeo._trace_contours_np(m))
        cv2_polys = [c.reshape(-1, 2).astype(np.float32)
                     for c in cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]]
        _assert_same_polys(polys, cv2_polys)
        largest = pgeo.mask_to_polygons(m, largest_only=True)
        if cv2_polys:
            np.testing.assert_array_equal(largest, max(cv2_polys, key=len))
        else:
            assert largest.shape == (0, 2)
        for pts in polys + [np.column_stack(np.nonzero(m))]:
            _assert_same_rect(pts)
        assert native.rle_encode(m) == pgeo._rle_encoding_np(m)
    for pts in _point_sets(15):
        _assert_same_rect(pts)
