"""Key-frame (insertion-start) detection and class-sequence repair.

Counterpart of ``yolo_puncture_tpu/analytics/keyframe.py``, the same numpy
arithmetic (bit-equal on any input):
  * ``find_insert_start``: the first window of ``judge_wnd`` frames with at
    least 0.9·wnd class-1 frames; inside it the highest threshold of
    [0.9, 0.8, 0.7, 0.6] with a run of 5 consecutive class-1 frames above it;
    the earliest such run; 0 when there is none;
  * ``fix_class_prob``: all 0 before the key frame, all 1 after it; a repaired
    frame's probability comes from the nearest same-class frame of the
    original sequence (earlier for 0, later for 1), else 0.6.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

THRESHOLDS = (0.9, 0.8, 0.7, 0.6)


def find_insert_start(class_list: Sequence[int], prob_list: Sequence[float], judge_wnd: int = 20) -> int:
    classes = np.asarray(class_list)
    probs = np.asarray(prob_list, dtype=np.float64)
    n = len(classes)
    if n < judge_wnd:
        return 0
    ones = classes == 1
    csum = np.concatenate([[0], np.cumsum(ones)])
    counts = csum[judge_wnd:] - csum[:n - judge_wnd + 1]  # class-1 count of the window at each start
    passing = np.flatnonzero(counts >= 0.9 * judge_wnd)
    if passing.size == 0:
        return 0

    # run5[t][p]: frames p..p+4 are class 1 with prob > THRESHOLDS[t]
    run5 = []
    for thr in THRESHOLDS:
        if n < 5:
            run5.append(np.zeros(0, dtype=bool))
            continue
        good = ones & (probs > thr)
        run5.append(np.lib.stride_tricks.sliding_window_view(good, 5).all(axis=1))

    k_max = judge_wnd - 4  # run starts k in [0, judge_wnd - 5]
    for i in passing:
        for r in run5:
            lo, hi = i, min(i + k_max, len(r))
            if lo >= hi:
                continue
            hits = np.flatnonzero(r[lo:hi])
            if hits.size:
                return int(i + hits[0])
    return 0


def fix_class_prob(class_list: Sequence[int], prob_list: Sequence[float],
                   class_index: int) -> Tuple[List[int], List[float]]:
    classes = np.asarray(class_list).copy()
    probs = np.asarray(prob_list, dtype=np.float64).copy()
    n = len(classes)
    orig_classes = classes.copy()
    orig_probs = probs.copy()

    before = np.arange(class_index)
    wrong_before = before[orig_classes[before] != 0]
    if wrong_before.size:
        zero_pos = np.flatnonzero(orig_classes[:class_index] == 0)
        for i in wrong_before:
            earlier = zero_pos[zero_pos < i]
            probs[i] = orig_probs[earlier[-1]] if earlier.size else 0.6
            classes[i] = 0

    after = np.arange(class_index + 1, n)
    wrong_after = after[orig_classes[after] != 1]
    if wrong_after.size:
        one_pos = np.flatnonzero(orig_classes == 1)
        for i in wrong_after:
            later = one_pos[one_pos > i]
            probs[i] = orig_probs[later[0]] if later.size else 0.6
            classes[i] = 1

    return classes.tolist(), probs.tolist()


def predict_and_find_start_inserted_from_scores(
    class_list: Sequence[int], prob_list: Sequence[float], judge_wnd: int = 20,
) -> Tuple[List[int], List[float], int]:
    """Key-frame search and repair given the classifier's outputs."""
    idx = find_insert_start(class_list, prob_list, judge_wnd)
    classes, probs = fix_class_prob(list(class_list), list(prob_list), idx)
    return classes, probs, idx
