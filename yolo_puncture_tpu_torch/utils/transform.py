"""Frame transforms on the host.

Counterpart of ``yolo_puncture_tpu/utils/transform.py``.  ``crop_frame`` centres
a crop_size² window on the box centre (truncated to int), clamps it to the
frame and, where asked, zero-pads the bottom and right up to full size; it
returns (crop, actual (x1, y1, x2, y2)).  The pipeline's device step cuts the
same crops on the card (``pipeline/runner.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def crop_frame(
    frame: np.ndarray,
    xyxy: Sequence[float],
    crop_size: int = 380,
    need_padding: bool = False,
) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    height, width = frame.shape[:2]
    x1, y1, x2, y2 = xyxy
    x_center, y_center = int((x1 + x2) / 2), int((y1 + y2) / 2)

    half = crop_size // 2
    x1 = max(0, x_center - half)
    y1 = max(0, y_center - half)
    x2 = min(width, x_center + half)
    y2 = min(height, y_center + half)

    cropped = frame[y1:y2, x1:x2]

    # the reference's `need_padding and a or b` binds as `(need_padding and a) or b`:
    # a crop narrower than crop_size is padded even without need_padding
    if (need_padding and cropped.shape[0] < crop_size) or cropped.shape[1] < crop_size:
        padded = np.zeros((crop_size, crop_size, 3), dtype=np.uint8)
        padded[:cropped.shape[0], :cropped.shape[1]] = cropped
        cropped = padded
    return cropped, (x1, y1, x2, y2)


def bgr_to_rgb(frame: np.ndarray) -> np.ndarray:
    return frame[..., ::-1]


def crop_frames_batch(frames, boxes: np.ndarray, crop_size: int = 380) -> np.ndarray:
    """``crop_frame(need_padding=True)`` over N frames → (N, crop_size, crop_size, 3) uint8."""
    out = np.zeros((len(frames), crop_size, crop_size, 3), dtype=np.uint8)
    for i, (f, b) in enumerate(zip(frames, boxes)):
        c, _ = crop_frame(f, b, crop_size, need_padding=True)
        out[i, :c.shape[0], :c.shape[1]] = c[:crop_size, :crop_size]
    return out
