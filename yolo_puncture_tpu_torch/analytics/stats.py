"""Offline speed statistics and evaluation metrics.

Counterpart of ``yolo_puncture_tpu/analytics/stats.py`` (the same numpy):
  * ``remove_outliers``: MAD modified-z filter;
  * ``calculate_speed_mm``: every pairwise speed within ±5 frames of the key interval;
  * ``compute_pixel_to_mm_ratio``: the 5 frames before the key frame, outliers removed;
  * ``compute_metrics``: relative speed deviation with the raw, Gaussian and
    Savitzky-Golay length series.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from yolo_puncture_tpu_torch.ops.signal import gaussian_smoothing, savitzky_golay_smoothing

INIT_SHAFT_LEN = 20.0


def remove_outliers(data: Sequence[float], m: float = 2.0) -> List[float]:
    data = np.array(data, dtype=np.float64)
    median = np.median(data)
    mad = np.median(np.abs(data - median))
    if mad == 0:
        return data.tolist()
    modified_z = 0.6745 * (data - median) / mad
    return data[np.abs(modified_z) < m].tolist()


def calculate_speed_mm(lens_mm: Sequence[float], start_frame: int, end_frame: int,
                       fps: float = 30.0) -> List[float]:
    """All pairwise speeds within ±5 frames of the key interval."""
    lens = np.asarray(lens_mm, dtype=np.float64)
    n = lens.size
    i_lo = max(0, start_frame - 5)
    i_hi = min(n - 1, end_frame + 5)  # i < i_hi
    j_hi = min(n, end_frame + 5)      # j < j_hi
    speeds: List[float] = []
    for i in range(i_lo, i_hi):
        js = np.arange(i + 1, j_hi)
        if js.size == 0:
            continue
        speeds.extend(((lens[i] - lens[js]) / ((js - i) / fps)).tolist())
    return speeds


def compute_pixel_to_mm_ratio(lens: Sequence[float], start_frame: int,
                              init_shaft_len: float = INIT_SHAFT_LEN) -> float:
    pre = list(lens[max(0, start_frame - 5):start_frame])
    if not pre:
        raise ValueError(
            f"Not enough frames before the insertion start frame {start_frame} "
            "to calculate the ratio."
        )
    cleaned = remove_outliers(pre, m=2)
    if not cleaned:
        raise ValueError("Not enough data to calculate the ratio after removing outliers.")
    return init_shaft_len / float(np.mean(cleaned))


def compute_metrics(
    lens: Sequence[float],
    pred_range: Tuple[int, int],
    act_range: Tuple[int, int],
    fps: float,
    bias: int = 5,
) -> Tuple[float, float, float]:
    """Relative speed deviation under raw / Gaussian / Savitzky-Golay smoothing."""
    predict_start, _ = pred_range
    actual_start, actual_end = act_range
    actual_speed = (2 * fps) / (actual_end - actual_start)

    def _one(adjust):
        adjust = list(adjust)
        pixel_lens = adjust[max(0, predict_start - bias):max(1, predict_start)]
        avg = sum(pixel_lens) / len(pixel_lens)
        adj_end = predict_start + 1
        for i in range(predict_start + 1, len(adjust)):
            if adjust[i] <= avg * 0.9:
                adj_end = i
                break
        speed = (2 * fps) / (adj_end - predict_start)
        return abs((actual_speed - speed) / actual_speed)

    return (
        _one(lens),
        _one(gaussian_smoothing(lens)),
        _one(savitzky_golay_smoothing(lens)),
    )
