"""Contours and result objects of the PyTorch port against the JAX package.

``Masks.xy`` takes the largest outer contour of each mask.  The JAX package
gets it from ``cv2.findContours``; the port does too where cv2 is installed,
and otherwise (as on a machine without cv2) from its own numpy tracer, which
must give cv2's polygons exactly, in cv2's order.  The Boxes / Masks accessors
must give the JAX package's arrays exactly.
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
    monkeypatch.setattr(pgeo, "_HAS_CV2", False)
    for m, r in zip(_masks(kind, seed=len(kind)), ref):
        _assert_same_polys(pgeo.mask_to_polygons(m), r)


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
