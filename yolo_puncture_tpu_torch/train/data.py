"""Dataset loading for YOLO-format segmentation fine-tuning.

Counterpart of ``yolo_puncture_tpu/train/data.py``: the ultralytics layout
(images/{split}/*.png|jpg with labels/{split}/*.txt of ``class x1 y1 x2 y2 …``
normalised polygons, or an images/labels pair of directories), fixed-shape
numpy batches:

  images    (B, S, S, 3) float RGB in [0, 1], letterboxed
  gt_labels (B, M) int32, gt_bboxes (B, M, 4) xyxy px, mask_gt (B, M) bool
  gt_masks  (B, M, S/4, S/4) float polygons rasterised at proto resolution

The same ``seed`` gives the JAX package's batches exactly: the augmentation
draws from a ``random.Random(seed)`` in the same order.  PNG files are read by
``utils/png.py`` and the letterbox resize is ``ops/resize.py
resize_linear_u8`` (cv2's INTER_LINEAR pixels), so the un-augmented path
(``load``, what ``yolo_cli val`` reads) needs cv2 only to fill polygons, and
not even then (``ops/geometry.py _fill_poly_np``); cv2 is imported where the
augmentation needs it (``warpAffine``, the HSV conversion) and to read other
image formats.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from yolo_puncture_tpu_torch.ops.letterbox import letterbox_params
from yolo_puncture_tpu_torch.ops.resize import resize_linear_u8


def _find_pairs(root: str, split: str) -> List[Tuple[str, str]]:
    img_dir = None
    for cand in (
        os.path.join(root, "images", split),
        os.path.join(root, split, "images"),
        os.path.join(root, "images"),
        root,
    ):
        if os.path.isdir(cand):
            img_dir = cand
            break
    if img_dir is None:
        raise FileNotFoundError(f"no images dir under {root}")
    pairs = []
    for f in sorted(os.listdir(img_dir)):
        if not f.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        img_path = os.path.join(img_dir, f)
        lbl_path = (
            img_path.replace(f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}")
            .rsplit(".", 1)[0]
            + ".txt"
        )
        pairs.append((img_path, lbl_path if os.path.exists(lbl_path) else ""))
    return pairs


def _parse_label(path: str) -> List[Tuple[int, np.ndarray]]:
    """Each line: class x1 y1 x2 y2 … (normalised polygon)."""
    out = []
    if not path or not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            vals = line.split()
            if len(vals) < 7:
                continue
            cls = int(float(vals[0]))
            poly = np.asarray(list(map(float, vals[1:])), np.float32).reshape(-1, 2)
            out.append((cls, poly))
    return out


def _imread(path: str) -> np.ndarray:
    """BGR uint8 (H, W, 3), as ``cv2.imread``: PNG without cv2, other formats through it."""
    from yolo_puncture_tpu_torch.utils.png import decode_image

    with open(path, "rb") as f:
        img = decode_image(f.read())
    if img is None:
        raise ValueError(f"cannot read image {path}")
    return img


def _resize(img: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """``cv2.resize(img, (nw, nh), interpolation=INTER_LINEAR)``."""
    return resize_linear_u8(torch.from_numpy(np.ascontiguousarray(img)), (nh, nw)).numpy()


def _rasterize(poly_px: np.ndarray, h: int, w: int) -> np.ndarray:
    try:
        import cv2

        m = np.zeros((h, w), np.uint8)
        cv2.fillPoly(m, [poly_px.astype(np.int32)], 1)
        return m.astype(np.float32)
    except ImportError:
        from yolo_puncture_tpu_torch.ops.geometry import _fill_poly_np

        m = np.zeros((h, w, 1), np.uint8)
        _fill_poly_np(m, poly_px.astype(np.int32), (1,))
        return m[..., 0].astype(np.float32)


def _poly_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1))))


class SegDataset:
    """YOLO-format segmentation dataset with train-time augmentation: 4-image
    mosaic, random scale and translation, horizontal flip, HSV jitter, with the
    ultralytics defaults (mosaic 1.0, scale 0.5, translate 0.1, fliplr 0.5, hsv
    0.015 / 0.7 / 0.4).  All geometry composes into one 2×3 affine applied once
    to the pixels (``cv2.warpAffine``) and once to the polygons.
    ``augment=False`` keeps the inference letterbox."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        imgsz: int = 640,
        max_boxes: int = 32,
        augment: bool = True,
        seed: int = 0,
        mosaic: float = 1.0,
        scale: float = 0.5,
        translate: float = 0.1,
        fliplr: float = 0.5,
        hsv_h: float = 0.015,
        hsv_s: float = 0.7,
        hsv_v: float = 0.4,
    ):
        self.pairs = _find_pairs(root, split)
        self.imgsz = imgsz
        self.max_boxes = max_boxes
        self.augment = augment
        self.rng = random.Random(seed)
        self.mosaic = mosaic
        self.scale = scale
        self.translate = translate
        self.fliplr = fliplr
        self.hsv = (hsv_h, hsv_s, hsv_v)

    def __len__(self):
        return len(self.pairs)

    def _targets(self, polys, S: int):
        """(class, polygon in canvas px) pairs → the padded label arrays."""
        M = self.max_boxes
        Hp = Wp = S // 4
        out = {"gt_labels": np.zeros(M, np.int32), "gt_bboxes": np.zeros((M, 4), np.float32),
               "mask_gt": np.zeros(M, bool), "gt_masks": np.zeros((M, Hp, Wp), np.float32)}
        for i, (cls, p) in enumerate(polys[:M]):
            x1, y1 = p.min(0)
            x2, y2 = p.max(0)
            out["gt_labels"][i] = cls
            out["gt_bboxes"][i] = (x1, y1, x2, y2)
            out["mask_gt"][i] = True
            out["gt_masks"][i] = _rasterize(p / 4.0, Hp, Wp)
        return out

    def load(self, idx: int, flip: bool = False) -> Dict[str, np.ndarray]:
        img_path, lbl_path = self.pairs[idx]
        img = _imread(img_path)
        h0, w0 = img.shape[:2]
        S = self.imgsz
        r, (nw, nh), (left, top) = letterbox_params(h0, w0, S)
        canvas = np.full((S, S, 3), 114, np.uint8)
        canvas[top : top + nh, left : left + nw] = _resize(img, nw, nh)
        if flip:
            canvas = canvas[:, ::-1].copy()
        polys = []
        for cls, poly in _parse_label(lbl_path)[: self.max_boxes]:
            poly_lb = poly * np.array([w0, h0], np.float32) * r + np.array([left, top], np.float32)
            if flip:
                poly_lb[:, 0] = S - poly_lb[:, 0]
            polys.append((cls, poly_lb))
        # BGR → RGB and /255, as the device path does for inference
        return {"images": canvas[..., ::-1].astype(np.float32) / 255.0, **self._targets(polys, S)}

    # -- the augmented path: mosaic + (scale / translate / flip as one affine) + HSV

    def _load_raw(self, idx: int) -> Tuple[np.ndarray, List[Tuple[int, np.ndarray]]]:
        """BGR image + (class, polygon in source pixels) labels."""
        img_path, lbl_path = self.pairs[idx]
        img = _imread(img_path)
        h0, w0 = img.shape[:2]
        return img, [(cls, poly * np.array([w0, h0], np.float32)) for cls, poly in _parse_label(lbl_path)]

    def _mosaic_canvas(self, idx: int):
        """4-image mosaic on a 2S canvas around a random centre: (canvas BGR,
        labels in canvas px, canvas size)."""
        S = self.imgsz
        C = 2 * S
        canvas = np.full((C, C, 3), 114, np.uint8)
        xc = int(self.rng.uniform(0.5 * S, 1.5 * S))
        yc = int(self.rng.uniform(0.5 * S, 1.5 * S))
        idxs = [idx] + [self.rng.randrange(len(self)) for _ in range(3)]
        labels_out: List[Tuple[int, np.ndarray]] = []
        for quad, j in enumerate(idxs):
            img, labels = self._load_raw(j)
            h0, w0 = img.shape[:2]
            r = S / max(h0, w0)
            nw, nh = max(1, round(w0 * r)), max(1, round(h0 * r))
            img = _resize(img, nw, nh)
            # each quadrant's inner corner at (xc, yc)
            x1 = xc - nw if quad in (0, 2) else xc
            y1 = yc - nh if quad in (0, 1) else yc
            sx1, sy1 = max(0, x1), max(0, y1)
            sx2, sy2 = min(C, x1 + nw), min(C, y1 + nh)
            if sx2 <= sx1 or sy2 <= sy1:
                continue
            canvas[sy1:sy2, sx1:sx2] = img[sy1 - y1 : sy2 - y1, sx1 - x1 : sx2 - x1]
            off = np.array([x1, y1], np.float32)
            for cls, poly in labels:
                labels_out.append((cls, poly * r + off))
        return canvas, labels_out, C

    def _hsv_jitter(self, img_bgr: np.ndarray) -> np.ndarray:
        import cv2

        hg, sg, vg = self.hsv
        if not (hg or sg or vg):
            return img_bgr
        fh = 1.0 + self.rng.uniform(-1, 1) * hg
        fs = 1.0 + self.rng.uniform(-1, 1) * sg
        fv = 1.0 + self.rng.uniform(-1, 1) * vg
        hsv = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2HSV).astype(np.float32)
        hsv[..., 0] = (hsv[..., 0] * fh) % 180.0
        hsv[..., 1] = np.clip(hsv[..., 1] * fs, 0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] * fv, 0, 255)
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        """One training sample through the augmentation."""
        if not self.augment:
            return self.load(idx)
        import cv2

        S = self.imgsz
        if self.rng.random() < self.mosaic:
            src, labels, C = self._mosaic_canvas(idx)
        else:
            img, raw = self._load_raw(idx)
            h0, w0 = img.shape[:2]
            r, (nw, nh), (left, top) = letterbox_params(h0, w0, S)
            src = np.full((S, S, 3), 114, np.uint8)
            src[top : top + nh, left : left + nw] = _resize(img, nw, nh)
            off = np.array([left, top], np.float32)
            labels = [(cls, poly * r + off) for cls, poly in raw]
            C = S

        # one affine: recentre the source → random scale → random translation → flip
        s = self.rng.uniform(1.0 - self.scale, 1.0 + self.scale)
        tx = S * (0.5 + self.rng.uniform(-1, 1) * self.translate)
        ty = S * (0.5 + self.rng.uniform(-1, 1) * self.translate)
        fx = -1.0 if self.rng.random() < self.fliplr else 1.0
        a = fx * s
        M = np.array([[a, 0.0, tx - a * (C / 2.0)], [0.0, s, ty - s * (C / 2.0)]], np.float32)
        out = cv2.warpAffine(src, M, (S, S), flags=cv2.INTER_LINEAR, borderValue=(114, 114, 114))
        out = self._hsv_jitter(out)

        polys = []
        for cls, poly in labels:
            if len(polys) >= self.max_boxes:
                break
            p = np.clip(poly @ M[:, :2].T + M[:, 2], 0.0, float(S))
            x1, y1 = p.min(0)
            x2, y2 = p.max(0)
            # drop boxes clipped to slivers and degenerate polygons
            if x2 - x1 < 2.0 or y2 - y1 < 2.0 or _poly_area(p) < 4.0:
                continue
            polys.append((cls, p))
        return {"images": out[..., ::-1].astype(np.float32) / 255.0, **self._targets(polys, S)}

    def batches(self, batch_size: int, shuffle: bool = True) -> Iterator[Dict]:
        order = list(range(len(self)))
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [self.sample(j) for j in order[i : i + batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
