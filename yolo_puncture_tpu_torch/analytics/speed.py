"""Insertion-speed state machine.

Counterpart of ``yolo_puncture_tpu/analytics/speed.py``.  Per frame: the
repaired class (0/1), the smoothed length and whether the detector found the
needle →
  * class 0, not inserted, detected: push the length into a rolling
    calibration window of CONFIRMATION_FRAMES (5);
  * class 1 with an empty window: seed the window with the current length;
  * actual length = 20 mm for class 0, else 20·len/mean(window);
  * at the key frame: inserted;
  * class 1, inserted and actual length ≤ 18 mm: the end frame, and
    speed = 2 mm / (Δframes / fps).

``insertion_state_machine`` is the host loop (the same Python as the JAX
package's, so its results are bit-equal).  ``insertion_state_machine_torch`` is
the fixed-shape tensor form of the JAX package's ``insertion_state_machine_jax``
(a ring buffer, no host synchronisation, fp32), for a series already on a device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

INIT_SHAFT_LEN = 20.0
MOVE_THRESHOLD = 2.0
CONFIRMATION_FRAMES = 5


@dataclass
class SpeedResult:
    start_frame: Optional[int]
    end_frame: Optional[int]
    speed_mm_s: Optional[float]
    actual_lens: np.ndarray  # per-frame calibrated shaft length (mm), NaN if skipped


def insertion_state_machine(
    classes: Sequence[int],
    smooth_lens: Sequence[float],
    detected: Sequence[bool],
    insert_start_frame: int,
    fps: float,
    init_shaft_len: float = INIT_SHAFT_LEN,
    move_threshold: float = MOVE_THRESHOLD,
    confirmation_frames: int = CONFIRMATION_FRAMES,
) -> SpeedResult:
    pixel_len_arr: list = []
    inserted = False
    end_frame = None
    speed = None
    n = len(classes)
    actual_lens = np.full(n, np.nan)

    for idx in range(n):
        cls = classes[idx]
        rect_len = smooth_lens[idx]
        if cls == 0 and not inserted and detected[idx]:
            pixel_len_arr.append(rect_len)
            if len(pixel_len_arr) > confirmation_frames:
                pixel_len_arr.pop(0)
        if cls == 1 and len(pixel_len_arr) == 0:
            pixel_len_arr.append(rect_len)
        if len(pixel_len_arr) == 0:
            continue  # nothing to calibrate against yet
        mean_len = sum(pixel_len_arr) / len(pixel_len_arr)
        # a zero-length calibration (every frame a dropout) cannot be divided by
        actual_len = (
            init_shaft_len
            if (cls == 0 or mean_len <= 0)
            else init_shaft_len * rect_len / mean_len
        )
        actual_lens[idx] = actual_len

        if idx == insert_start_frame:
            inserted = True

        if cls == 1 and inserted and actual_len <= init_shaft_len - move_threshold:
            # the loop goes on after the trigger; it cannot fire again, since
            # inserted is reset and idx == insert_start_frame never recurs
            inserted = False
            end_frame = idx
            interval_time = max(1, end_frame - insert_start_frame) / fps
            speed = move_threshold / interval_time

    return SpeedResult(
        start_frame=insert_start_frame,
        end_frame=end_frame,
        speed_mm_s=speed,
        actual_lens=actual_lens,
    )


def insertion_state_machine_torch(
    classes,
    smooth_lens,
    detected,
    insert_start_frame,
    fps: float,
    init_shaft_len: float = INIT_SHAFT_LEN,
    move_threshold: float = MOVE_THRESHOLD,
    confirmation_frames: int = CONFIRMATION_FRAMES,
):
    """Tensor form: a (confirmation_frames,) ring buffer and ``torch.where`` for
    every branch, so nothing waits for the device.  Inputs are tensors or array
    likes; it runs on the lengths' device (the CPU for an array).

    Returns 0-d tensors (start_frame, end_frame, speed) and actual_lens (n,)
    fp32; end_frame = -1 and speed = 0.0 when the 2 mm depth is never reached,
    NaN actual lengths before the first calibration."""
    device = smooth_lens.device if isinstance(smooth_lens, torch.Tensor) else torch.device("cpu")
    K = confirmation_frames
    classes = torch.as_tensor(classes, device=device).to(torch.int32)
    lens = torch.as_tensor(smooth_lens, device=device).to(torch.float32)
    detected = torch.as_tensor(detected, device=device).to(torch.bool)
    start = torch.as_tensor(insert_start_frame, device=device).to(torch.int32)
    n = classes.shape[0]

    slots = torch.arange(K, device=device)
    buf = torch.zeros(K, dtype=torch.float32, device=device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    inserted = torch.zeros((), dtype=torch.bool, device=device)
    end_frame = torch.full((), -1, dtype=torch.int32, device=device)
    speed = torch.zeros((), dtype=torch.float32, device=device)
    one, nan = torch.ones((), device=device), torch.full((), float("nan"), device=device)
    actual = []
    for i in range(n):
        cls, rect_len, det = classes[i], lens[i], detected[i]
        push = ((cls == 0) & ~inserted & det) | ((cls == 1) & (count == 0))
        # overwriting the oldest slot once the window is full is the list's pop(0) + append
        buf = torch.where(push & (slots == pos), rect_len, buf)
        pos = torch.where(push, (pos + 1) % K, pos)
        count = torch.where(push, torch.clamp(count + 1, max=K), count)

        have = count > 0
        mean = torch.where(have, (buf * (slots < count)).sum() / torch.clamp(count, min=1), one)
        no_cal = mean <= 0
        actual_len = torch.where((cls == 0) | no_cal, torch.full_like(mean, init_shaft_len),
                                 init_shaft_len * rect_len / torch.where(no_cal, one, mean))
        actual.append(torch.where(have, actual_len, nan))

        inserted = inserted | ((start == i) & have)
        trigger = ((cls == 1) & inserted & (actual_len <= init_shaft_len - move_threshold)
                   & have & (end_frame < 0))
        end_frame = torch.where(trigger, torch.full_like(end_frame, i), end_frame)
        interval = torch.clamp(i - start, min=1).to(torch.float32) / fps
        speed = torch.where(trigger, move_threshold / interval, speed)
        inserted = inserted & ~trigger
    actual_lens = torch.stack(actual) if actual else torch.zeros(0, dtype=torch.float32, device=device)
    return start, end_frame, speed, actual_lens
