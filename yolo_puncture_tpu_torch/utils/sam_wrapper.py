"""SAM convenience wrapper and overlay helper: ``segment_anything`` and ``show_anns``.

Counterpart of ``yolo_puncture_tpu/utils/sam_wrapper.py`` (the reference's
``yolo_seg/utils/segment_anything.py`` surface).
"""

from __future__ import annotations

import os
import sys
from typing import List

import numpy as np

from yolo_puncture_tpu_torch.utils.config import get_config


def segment_anything(image: np.ndarray, model_type: str = "vit_l", device=None) -> List[dict]:
    """SAM's automatic mask generation with the reference's settings
    (``crop_n_layers=1``, ``crop_n_points_downscale_factor=2``) on ``device``
    (``None``: the card; ``"cpu"``).  The weights are looked up at
    ``{WEIGHTS_PATH}/sam/sam_{model_type}.pth``; without that file the model is a
    seeded random init, and a warning says so on stderr."""
    from yolo_puncture_tpu_torch.models.sam import SamAutomaticMaskGenerator, sam_model_registry

    ckpt = os.path.join(get_config().PATH.WEIGHTS_PATH, "sam", f"sam_{model_type}.pth")
    if not os.path.exists(ckpt):
        # loud, not silent: a random-weight SAM returns plausible-looking but
        # meaningless masks that would be persisted as annotations
        print(f"WARNING: SAM checkpoint {ckpt} not found — generating with "
              "RANDOM weights (annotation output will be meaningless)", file=sys.stderr)
        ckpt = None
    sam = sam_model_registry[model_type](checkpoint=ckpt, device=device)
    return SamAutomaticMaskGenerator(sam, crop_n_layers=1, crop_n_points_downscale_factor=2).generate(image)


def show_anns(frame_shape, anns, x_offset: int = 0, y_offset: int = 0) -> np.ndarray:
    """Paint SAM masks into an RGB overlay, one colour from ``np.random`` a mask,
    with each mask's area written at its centre (cv2's ``putText``, imported here)."""
    import cv2

    if not isinstance(anns, (list, np.ndarray)):
        anns = [anns]
    if len(anns) == 0:
        return np.zeros(frame_shape, dtype=np.uint8)
    height, width = frame_shape[0], frame_shape[1]
    mask = np.zeros((height, width, 3), dtype=np.uint8)
    for ann in anns:
        seg = np.asarray(ann["segmentation"], bool)
        color = np.random.randint(0, 255, (3,), dtype=int)
        ys, xs = np.where(seg)
        if len(ys) == 0:
            continue
        mask[np.clip(ys + y_offset, 0, height - 1), np.clip(xs + x_offset, 0, width - 1)] = color
        center = (int(np.mean(xs) + x_offset), int(np.mean(ys) + y_offset))
        cv2.putText(mask, f"{ann['area']:.1f}", center, cv2.FONT_HERSHEY_SIMPLEX, 1.0, (255, 255, 255), 2,
                    cv2.LINE_AA)
    return mask
