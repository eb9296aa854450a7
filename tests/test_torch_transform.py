"""The port's frame crops against the JAX package's: ``crop_frame`` with the box
centre at each of the four edges, in the corners, inside, outside the frame's
crop-sized margin, with and without ``need_padding`` (the reference's operator
precedence: a crop narrower than crop_size is padded even without it), and
``crop_frames_batch``."""

import numpy as np
import pytest

from tests.torch_parity import torch_single_thread  # noqa: F401
from yolo_puncture_tpu.utils import transform as jtr
from yolo_puncture_tpu_torch.utils import transform as ptr

H, W, CROP = 90, 140, 40


def _frame(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (H, W, 3), dtype=np.uint8)


# box centres (x, y): the four edges, the four corners, the middle, and boxes whose
# centre truncates (x.5) or reaches past the frame
BOXES = {
    "left": (0, 40, 10, 50), "right": (130, 40, 140, 50), "top": (60, 0, 80, 6), "bottom": (60, 84, 80, 90),
    "top-left": (0, 0, 4, 4), "bottom-right": (136, 86, 140, 90), "top-right": (135, 1, 140, 3),
    "bottom-left": (1, 85, 2, 90), "middle": (60.7, 30.2, 81.9, 55.6), "past": (120, 70, 170, 120),
}


@pytest.mark.parametrize("need_padding", [False, True])
@pytest.mark.parametrize("where", BOXES)
def test_crop_frame_matches_jax(where, need_padding):
    frame = _frame()
    got, got_xyxy = ptr.crop_frame(frame, BOXES[where], CROP, need_padding)
    ref, ref_xyxy = jtr.crop_frame(frame, BOXES[where], CROP, need_padding)
    assert got_xyxy == ref_xyxy
    np.testing.assert_array_equal(got, ref)


def test_narrow_crop_is_padded_without_need_padding():
    """The reference's `need_padding and a or b`: at the left edge the crop is
    narrower than crop_size and comes back padded; at the top it is only
    shorter and comes back as cut."""
    frame = _frame()
    assert ptr.crop_frame(frame, BOXES["left"], CROP)[0].shape == (CROP, CROP, 3)
    assert ptr.crop_frame(frame, BOXES["top"], CROP)[0].shape == (23, CROP, 3)


def test_crop_frames_batch_and_bgr_to_rgb_match_jax():
    frames = [_frame(i) for i in range(len(BOXES))]
    boxes = np.asarray(list(BOXES.values()), np.float64)
    got = ptr.crop_frames_batch(frames, boxes, CROP)
    assert got.shape == (len(BOXES), CROP, CROP, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jtr.crop_frames_batch(frames, boxes, CROP))
    np.testing.assert_array_equal(ptr.bgr_to_rgb(frames[0]), jtr.bgr_to_rgb(frames[0]))
