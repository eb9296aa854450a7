"""The port's cv2-free resizes against cv2, which the JAX package's tracker calls
on the host: INTER_LINEAR on uint8 frames and INTER_NEAREST on id masks, exact."""

import cv2
import numpy as np
import pytest
import torch

from yolo_puncture_tpu_torch.ops.resize import resize_linear_u8, resize_nearest

SHAPES = [  # (source, destination): 720p and 1080p to the serving geometry, exact 2×, up, mixed
    ((720, 1280), (480, 864)),
    ((1080, 1920), (480, 864)),
    ((96, 160), (48, 80)),
    ((64, 64), (32, 64)),
    ((33, 45), (64, 96)),
    ((100, 37), (64, 96)),
    ((90, 150), (64, 96)),
]


@pytest.mark.parametrize("src,dst", SHAPES)
def test_linear_u8_matches_cv2(src, dst):
    img = np.random.default_rng(0).integers(0, 256, (*src, 3)).astype(np.uint8)
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_linear_u8(torch.from_numpy(img), dst).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("src,dst", SHAPES)
def test_nearest_matches_cv2(src, dst):
    m = np.random.default_rng(1).integers(0, 5, src).astype(np.int32)
    np.testing.assert_array_equal(resize_nearest(m, dst), cv2.resize(m, dst[::-1], interpolation=cv2.INTER_NEAREST))


def test_same_size_is_returned_as_is_and_bad_input_raises():
    img = torch.zeros(8, 8, 3, dtype=torch.uint8)
    assert resize_linear_u8(img, (8, 8)) is img
    with pytest.raises(ValueError):
        resize_linear_u8(img.float(), (4, 4))
