"""The tracker's result saver: ``ResultSaver``, ``flush_buffer`` and
``get_input_frame_for_deva``.

Counterpart of ``yolo_puncture_tpu/track/saver.py``.  ``save_mask(prob, name,
need_resize, shape, image_np)`` paints the argmax id mask of a frame with a
fixed palette (``RandomState(42)``, id 0 black) into
``<output_root>/Annotations/<video>/<frame>.png`` and appends the frame's
segments (id, category, area) to ``video_json``; ``end()`` returns it.
``flush_buffer`` propagates the frames left in a tracker's semi-online buffer.

Where the JAX file calls cv2, the port takes cv2's arithmetic without cv2: id
masks are resized with ``ops/resize.py resize_nearest`` (INTER_NEAREST), frames
with ``resize_linear_u8`` (INTER_LINEAR on uint8), and the PNGs are written by
``utils/png.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from yolo_puncture_tpu_torch.ops.resize import resize_linear_u8, resize_nearest
from yolo_puncture_tpu_torch.utils.png import write_png_rgb


def _id_palette(n: int = 256, seed: int = 42) -> np.ndarray:
    pal = np.random.RandomState(seed).randint(0, 255, size=(n, 3), dtype=np.uint8)
    pal[0] = 0
    return pal


class ResultSaver:
    def __init__(self, output_root: str, video_name: str, dataset: str = "demo", object_manager=None):
        self.output_root = output_root
        self.video_name = video_name
        self.dataset = dataset
        self.object_manager = object_manager
        self.palette = _id_palette()
        self.video_json = {"video": video_name, "annotations": []}
        self.mask_dir = os.path.join(output_root, "Annotations", video_name)
        os.makedirs(self.mask_dir, exist_ok=True)

    def save_mask(self, prob: np.ndarray, frame_name: str, need_resize: bool = False,
                  shape: Optional[Tuple[int, int]] = None, image_np: Optional[np.ndarray] = None):
        """prob: (No+1, H, W) probabilities, channel 0 the background."""
        idx_mask = np.argmax(np.asarray(prob), axis=0).astype(np.int32)
        if need_resize and shape is not None:
            idx_mask = resize_nearest(idx_mask, tuple(shape))
        rgb = self.palette[idx_mask % len(self.palette)]
        write_png_rgb(os.path.join(self.mask_dir, os.path.splitext(frame_name)[0] + ".png"), rgb)

        segments = []
        areas = np.bincount(idx_mask.ravel())                 # the pixels of each id, in id order
        for slot_id in np.flatnonzero(areas[1:]) + 1:
            info = None
            if self.object_manager is not None:
                info = self.object_manager.slot_to_info.get(int(slot_id) - 1)
            segments.append({
                "id": int(info.id) if info else int(slot_id),
                "category_id": int(info.category_id) if info else 0,
                "area": int(areas[slot_id]),
            })
        self.video_json["annotations"].append({"file_name": frame_name, "segments_info": segments})

    def end(self):
        return self.video_json


def flush_buffer(tracker, result_saver: ResultSaver):
    """Propagate the frames left in the tracker's semi-online buffer, save each."""
    for frame_info in tracker.frame_buffer:
        prob = tracker.step(frame_info.image, None, None)
        h, w = frame_info.info["shape"]
        result_saver.save_mask(prob, frame_info.name, need_resize=True, shape=(h, w),
                               image_np=frame_info.image_np)
    tracker.clear_buffer()


def get_input_frame_for_deva(image_np: np.ndarray, min_side: int) -> np.ndarray:
    """The uint8 (H, W, C) frame with its shorter side resized to ``min_side``
    (``cv2.resize``'s INTER_LINEAR); ``min_side <= 0`` returns it as it is."""
    if min_side <= 0:
        return image_np
    h, w = image_np.shape[:2]
    scale = min_side / min(h, w)
    return resize_linear_u8(torch.from_numpy(np.ascontiguousarray(image_np)),
                            (int(h * scale), int(w * scale))).numpy()
