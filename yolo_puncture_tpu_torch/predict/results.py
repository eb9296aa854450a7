"""Ultralytics-compatible result objects (host-side numpy).

Counterpart of ``yolo_puncture_tpu/predict/results.py``:
``results[0].boxes.cls / .conf / .xyxy / .xywh / .xyxyn``, ``.cpu().numpy()``
chaining, ``results[0].masks.xy`` (largest outer contour per instance, original
frame coordinates) and ``.masks.data`` (N, H, W) float {0, 1};
``results[0].plot()`` draws them on the frame.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from yolo_puncture_tpu_torch.ops.geometry import mask_to_polygons


class Boxes:
    """Detected boxes, as ultralytics ``Boxes`` (numpy arrays)."""

    def __init__(self, xyxy: np.ndarray, conf: np.ndarray, cls: np.ndarray, orig_shape):
        self._xyxy = np.asarray(xyxy, dtype=np.float32).reshape(-1, 4)
        self.conf = np.asarray(conf, dtype=np.float32).reshape(-1)
        self.cls = np.asarray(cls, dtype=np.float32).reshape(-1)
        self.orig_shape = orig_shape  # (h, w)

    @property
    def xyxy(self) -> np.ndarray:
        return self._xyxy

    @property
    def xywh(self) -> np.ndarray:
        b = self._xyxy
        return np.concatenate([(b[:, 2:] + b[:, :2]) / 2, b[:, 2:] - b[:, :2]], axis=1)

    @property
    def xyxyn(self) -> np.ndarray:
        h, w = self.orig_shape
        return self._xyxy / np.array([w, h, w, h], dtype=np.float32)

    @property
    def xywhn(self) -> np.ndarray:
        h, w = self.orig_shape
        return self.xywh / np.array([w, h, w, h], dtype=np.float32)

    @property
    def data(self) -> np.ndarray:
        return np.concatenate([self._xyxy, self.conf[:, None], self.cls[:, None]], axis=1)

    def cpu(self):
        return self

    def numpy(self):
        return self

    def __len__(self):
        return len(self.conf)

    def __getitem__(self, i):
        return Boxes(self._xyxy[i], self.conf[i], self.cls[i], self.orig_shape)


class Masks:
    """Instance masks: ``.data`` (N, H, W) float {0, 1}, ``.xy`` polygons."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data, dtype=np.float32)
        self.orig_shape = orig_shape
        self._xy: Optional[List[np.ndarray]] = None

    @property
    def xy(self) -> List[np.ndarray]:
        """Largest outer contour per instance, float32 (x, y) in original
        coordinates (ultralytics masks2segments strategy='largest')."""
        if self._xy is None:
            self._xy = [mask_to_polygons(m > 0.5, largest_only=True) for m in self.data]
        return self._xy

    @property
    def xyn(self) -> List[np.ndarray]:
        h, w = self.orig_shape
        return [p / np.array([w, h], np.float32) for p in self.xy]

    def cpu(self):
        return self

    def numpy(self):
        return self

    def __len__(self):
        return len(self.data)


class Results:
    """Per-image prediction result (ultralytics ``Results`` surface)."""

    def __init__(self, orig_img: Optional[np.ndarray], boxes: Boxes, masks: Optional[Masks] = None,
                 names: Optional[dict] = None, speed: Optional[dict] = None, path: str = ""):
        self.orig_img = orig_img
        self.orig_shape = boxes.orig_shape
        self.boxes = boxes
        self.masks = masks
        self.names = names or {}
        self.speed = speed or {}
        self.path = path

    def __len__(self):
        return len(self.boxes)

    def plot(self, line_width: int = 2, alpha: float = 0.4) -> np.ndarray:
        """Annotated BGR image, the JAX package's ``Results.plot``: each mask blended
        in at ``alpha`` with a colour from ``default_rng(7)``, then, where cv2 is
        installed, each box and its ``name conf`` label in the same colour."""
        img = self.orig_img.copy() if self.orig_img is not None else np.zeros((*self.orig_shape, 3), np.uint8)
        rng = np.random.default_rng(7)
        colors = rng.integers(64, 255, size=(max(len(self.boxes), 1), 3))
        if self.masks is not None:
            for i, m in enumerate(self.masks.data):
                col = colors[i % len(colors)]
                sel = m > 0.5
                img[sel] = (img[sel] * (1 - alpha) + col * alpha).astype(np.uint8)
        try:
            import cv2
        except ImportError:
            return img
        for i in range(len(self.boxes)):
            x1, y1, x2, y2 = self.boxes.xyxy[i].astype(int)
            col = tuple(int(c) for c in colors[i % len(colors)])
            cv2.rectangle(img, (x1, y1), (x2, y2), col, line_width)
            cls_id = int(self.boxes.cls[i])
            label = f"{self.names.get(cls_id, cls_id)} {self.boxes.conf[i]:.2f}"
            cv2.putText(img, label, (x1, max(12, y1 - 4)), cv2.FONT_HERSHEY_SIMPLEX, 0.5, col, 1, cv2.LINE_AA)
        return img
