"""Letterbox of the PyTorch port against the JAX package on uint8 frames.

Exact integer downscales (720×1280 → 640: n = 2; 1080×1920 → 640: n = 3) and
one general ratio, with and without the BGR flip.  atol 1e-6: the same cv2
taps, summed in another order in fp32.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)

# both packages' ops/__init__ re-export the function under the module's name
plb = importlib.import_module("yolo_puncture_tpu_torch.ops.letterbox")
jlb = importlib.import_module("yolo_puncture_tpu.ops.letterbox")


def _frames(B, H, W, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, H, W, 3), dtype=np.uint8)


@pytest.mark.parametrize("B,H,W,new", [
    (2, 720, 1280, 640),   # exact n = 2
    (1, 1080, 1920, 640),  # exact n = 3
    (2, 100, 150, 64),     # general ratio
    (1, 40, 30, 64),       # upscale
    (1, 64, 64, 64),       # same size
])
@pytest.mark.parametrize("bgr_to_rgb", [False, True])
def test_letterbox_matches_jax(B, H, W, new, bgr_to_rgb):
    frames = _frames(B, H, W, seed=H + W)
    ref, r_ref, pad_ref = jlb.letterbox(jnp.asarray(frames), new, bgr_to_rgb=bgr_to_rgb)
    got, r, pad = plb.letterbox(torch.from_numpy(frames), new, bgr_to_rgb=bgr_to_rgb)
    assert (r, pad) == (r_ref, pad_ref)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, new, new, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("h,w,new", [(720, 1280, 640), (1080, 1920, 640), (97, 161, 64),
                                     (481, 640, 640), (100, 150, 64)])
def test_letterbox_params_match_jax(h, w, new):
    assert plb.letterbox_params(h, w, new) == jlb.letterbox_params(h, w, new)
    assert plb.letterbox_params(h, w, new, scaleup=False) == jlb.letterbox_params(h, w, new, scaleup=False)


def test_scale_boxes_and_coords_match_jax():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(-20, 660, (3, 7, 4)).astype(np.float32)
    pts = rng.uniform(-20, 660, (5, 2)).astype(np.float32)
    r, pad, hw = 0.5, (0, 140), (720, 1280)
    np.testing.assert_allclose(plb.scale_boxes(torch.from_numpy(boxes), r, pad, hw).numpy(),
                               np.asarray(jlb.scale_boxes(jnp.asarray(boxes), r, pad, hw)), atol=1e-5)
    np.testing.assert_allclose(plb.scale_coords(torch.from_numpy(pts), r, pad, hw).numpy(),
                               np.asarray(jlb.scale_coords(jnp.asarray(pts), r, pad, hw)), atol=1e-5)


def test_cv2_linear_taps_match_jax():
    for n in range(1, 7):
        assert plb._cv2_linear_taps(n) == jlb._cv2_linear_taps(n)
