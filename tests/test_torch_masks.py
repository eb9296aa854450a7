"""Mask resamplers of the PyTorch port against the JAX package (atol 1e-5).

``paste_masks_to_original`` is ``jax.image.scale_and_translate(method="linear")``
in the JAX package, which antialiases when it downscales; the downscale case
below fails without that widening.  Pads are fractional, as on the stride-4
proto path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from yolo_puncture_tpu.ops import masks as jm
from yolo_puncture_tpu_torch.ops import masks as pm

ATOL = 1e-5


def _masks(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("src,dst", [((16, 24), (64, 96)), ((10, 10), (37, 23))])
def test_upsample_bilinear_matmul_matches_jax(src, dst):
    x = _masks((2, 3, *src), 0)
    ref = jm.upsample_bilinear_matmul(jnp.asarray(x), *dst)
    got = pm.upsample_bilinear_matmul(torch.from_numpy(x), *dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_crop_masks_matches_jax():
    x = _masks((2, 4, 20, 30), 1)
    rng = np.random.default_rng(2)
    boxes = np.concatenate([rng.uniform(-3, 15, (2, 4, 2)), rng.uniform(10, 33, (2, 4, 2))], -1)
    boxes[0, :2] = np.round(boxes[0, :2])  # integer edges: half-open on both sides
    boxes = boxes.astype(np.float32)
    ref = jm.crop_masks(jnp.asarray(x), jnp.asarray(boxes))
    got = pm.crop_masks(torch.from_numpy(x), torch.from_numpy(boxes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", [
    # (mask hw, r, (left, top), original hw)
    ((16, 16), 64 / 160 / 4, (0.0, 2.5), (96, 160)),      # upscale, fractional pad (predict geometry)
    ((40, 40), 0.5 * 4.0, (0.25, 3.75), (14, 18)),       # downscale: antialiasing matters
    ((160, 160), 0.5 / 4, (0.0, 35.0), (720, 1280)),      # serving geometry, 720p
])
def test_paste_masks_to_original_matches_jax(case):
    hw, r, pad, orig = case
    x = _masks((1, 3, *hw), 3)
    ref = jm.paste_masks_to_original(jnp.asarray(x), r, pad, orig)
    got = pm.paste_masks_to_original(torch.from_numpy(x), r, pad, orig)
    assert tuple(got.shape) == (1, 3, *orig)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("threshold", [None, 0.5])
def test_decode_masks_retina_upsample_matches_jax(threshold):
    rng = np.random.default_rng(4)
    protos = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    coeffs = (0.5 * rng.standard_normal((2, 3, 32))).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0, 12, (2, 3, 2)), rng.uniform(16, 32, (2, 3, 2))], -1)
    boxes = boxes.astype(np.float32)
    args = ((32, 32),)
    ref = np.asarray(jm.decode_masks(jnp.asarray(protos), jnp.asarray(coeffs), jnp.asarray(boxes),
                                     *args, upsample=True, threshold=threshold))
    got = pm.decode_masks(torch.from_numpy(protos), torch.from_numpy(coeffs), torch.from_numpy(boxes),
                          *args, upsample=True, threshold=threshold).numpy()
    if threshold is None:
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    else:
        soft = np.asarray(jm.decode_masks(jnp.asarray(protos), jnp.asarray(coeffs), jnp.asarray(boxes),
                                          *args, upsample=True, threshold=None))
        assert not ((got != ref) & (np.abs(soft - threshold) > ATOL)).any()
