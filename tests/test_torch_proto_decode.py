"""Proto-mask decode of the PyTorch port against the JAX package.

The port's plain version (what the wrapper runs on CPU tensors) is held to
``proto_decode_pallas`` in interpret mode and to ``ops/masks.py decode_masks``
at proto resolution, on the same numpy inputs.  Soft masks agree to 1e-6
(fp32 dot products of 32 terms summed in another order); binary masks are
identical except where the soft value lies within 1e-6 of the threshold.
The CUDA kernel itself is held to the plain version by ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from tests.torch_parity import assert_masks_match, proto_decode_inputs
from yolo_puncture_tpu.ops.masks import decode_masks as jax_decode_masks
from yolo_puncture_tpu.ops.pallas.proto_decode import proto_decode_pallas
from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode
from yolo_puncture_tpu_torch.ops.masks import decode_masks

CASES = [  # (B, N, Hp, Wp): 10·12 = 120 and 9·13 = 117 pixels are not multiples of 512
    (2, 5, 16, 32),
    (2, 7, 10, 12),
    (1, 3, 9, 13),
]


@pytest.mark.parametrize("shape", CASES)
@pytest.mark.parametrize("threshold", [None, 0.5])
@pytest.mark.parametrize("crop", [True, False])
def test_plain_version_matches_pallas_interpret(shape, threshold, crop):
    B, N, Hp, Wp = shape
    protos, coeffs, boxes = proto_decode_inputs(B, N, Hp, Wp, seed=B * 100 + N)
    # the Pallas kernel always crops: crop=False is a full-extent box
    kboxes = boxes if crop else np.tile(np.float32([0, 0, Wp, Hp]), (B, N, 1))
    ref = np.stack([
        np.asarray(proto_decode_pallas(jnp.asarray(protos[b]), jnp.asarray(coeffs[b]),
                                       jnp.asarray(kboxes[b]), threshold=threshold, interpret=True))
        for b in range(B)
    ])
    soft_ref = np.stack([
        np.asarray(proto_decode_pallas(jnp.asarray(protos[b]), jnp.asarray(coeffs[b]),
                                       jnp.asarray(kboxes[b]), threshold=None, interpret=True))
        for b in range(B)
    ])
    got = proto_decode(torch.from_numpy(protos).permute(0, 3, 1, 2).contiguous(),
                       torch.from_numpy(coeffs), torch.from_numpy(boxes), threshold, crop).numpy()
    assert got.shape == (B, N, Hp, Wp) and got.dtype == np.float32
    assert_masks_match(got, ref, soft_ref, threshold)


@pytest.mark.parametrize("threshold", [None, 0.5])
@pytest.mark.parametrize("crop", [True, False])
def test_decode_masks_at_proto_resolution_matches_jax(threshold, crop):
    B, N, Hp, Wp, img = 2, 6, 16, 16, (64, 64)
    protos, coeffs, boxes = proto_decode_inputs(B, N, Hp, Wp, seed=3)
    boxes = boxes * 4  # letterboxed-image pixels; decode scales them to proto pixels
    ref = np.asarray(jax_decode_masks(jnp.asarray(protos), jnp.asarray(coeffs), jnp.asarray(boxes),
                                      img, upsample=False, threshold=threshold, crop=crop))
    soft_ref = np.asarray(jax_decode_masks(jnp.asarray(protos), jnp.asarray(coeffs), jnp.asarray(boxes),
                                           img, upsample=False, threshold=None, crop=crop))
    got = decode_masks(torch.from_numpy(protos), torch.from_numpy(coeffs), torch.from_numpy(boxes),
                       img, upsample=False, threshold=threshold, crop=crop).numpy()
    assert_masks_match(got, ref, soft_ref, threshold)


def test_wrapper_checks_shapes():
    protos = torch.zeros(1, 32, 4, 4)
    with pytest.raises(ValueError):
        proto_decode(protos, torch.zeros(1, 3, 16), torch.zeros(1, 3, 4))
    with pytest.raises(ValueError):
        proto_decode(protos, torch.zeros(1, 3, 32), torch.zeros(1, 2, 4))


# -- the threshold as a logit: what the kernel compares when 0 < threshold < 1 ---------------------

from tests.torch_parity import PROTO_BAND as THRESH_BAND  # noqa: E402
from yolo_puncture_tpu_torch.ops.kernels.proto_decode import (  # noqa: E402
    box_inside,
    proto_decode_reference,
    threshold_logit,
)


@pytest.mark.parametrize("threshold", [0.5, 0.3, 0.9, 0.02])
@pytest.mark.parametrize("crop", [True, False])
def test_logit_threshold_gives_the_same_binary_masks(threshold, crop):
    """x > logit(t), with logit(t) from float64 and x the fp32 product, against the
    plain version's sigmoid(x) > t: equal outside the band around the threshold."""
    B, N, Hp, Wp = 2, 9, 24, 20
    protos, coeffs, boxes = proto_decode_inputs(B, N, Hp, Wp, seed=11)
    p = torch.from_numpy(protos).permute(0, 3, 1, 2).contiguous()
    c, b = torch.from_numpy(coeffs), torch.from_numpy(boxes)
    level = threshold_logit(threshold)
    assert level == pytest.approx(np.log(threshold / (1 - threshold)), rel=1e-12, abs=1e-15)
    x = torch.matmul(c, p.reshape(B, 32, Hp * Wp)).reshape(B, N, Hp, Wp)
    got = x > np.float32(level)
    if crop:
        got &= box_inside(b, Hp, Wp)
    ref = proto_decode_reference(p, c, b, threshold, crop)
    soft = proto_decode_reference(p, c, b, None, crop)
    differ = (got.float() != ref) & ((soft - threshold).abs() > THRESH_BAND)
    assert int(differ.sum()) == 0
    assert 0 < int(ref.sum()) < ref.numel()


@pytest.mark.parametrize("threshold", [None, 0.0, 1.0, -0.5, 1.5])
def test_no_logit_outside_the_open_interval(threshold):
    """There the kernel keeps the sigmoid: its fp32 saturation decides sigmoid(x) > 0 and > 1."""
    assert threshold_logit(threshold) is None
