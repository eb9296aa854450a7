"""Letterbox preprocessing on the device, and its inverse for boxes and points.

Counterpart of ``yolo_puncture_tpu/ops/letterbox.py``: ultralytics ``LetterBox``
(aspect-preserving resize, centred pad to a square with value 114) with cv2
``INTER_LINEAR`` arithmetic, so uint8 frames give the same pixels as the JAX
package and the reference's host letterbox.  Frames go in as (B, H, W, C) and
come out as (B, new, new, C) float in [0, 1], the JAX package's layout, in the
target ``dtype``.  As the JAX package computes it, a bf16 letterbox is bf16
arithmetic, not a cast of the fp32 result: tap weights are rounded to bf16,
products summed in fp32, and intermediates rounded to bf16 where the JAX
package rounds them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from yolo_puncture_tpu_torch.ops.masks import _interp_matrix


# output lanes of a block of the JAX package's lane-mix contraction: where new_w·C
# is a multiple of it, it mixes the W taps before the H taps
_MIX_OUT_BLOCK = 384


def _cv2_linear_taps(n: int):
    """cv2.resize INTER_LINEAR taps for an exact integer downscale by n.

    cv2 samples source position n·j + (n−1)/2 with a 2-tap triangle and no
    anti-aliasing: odd n lands on one pixel, even n halfway between the two
    middle pixels of the block."""
    if n % 2 == 1:
        return (((n - 1) // 2, 1.0),)
    return ((n // 2 - 1, 0.5), (n // 2, 0.5))


def letterbox_params(h: int, w: int, new_shape: int, scaleup: bool = True):
    """Resize/pad geometry for an (h, w) frame → (new_shape, new_shape):
    r = min(new/h, new/w) (≤ 1 unless scaleup), new_unpad = round(w·r), round(h·r),
    padding split evenly.  Returns (r, (new_w, new_h), (left, top)).  Python's
    round() (banker's rounding) as ultralytics uses it."""
    r = min(new_shape / h, new_shape / w)
    if not scaleup:
        r = min(r, 1.0)
    new_w, new_h = round(w * r), round(h * r)
    dw, dh = (new_shape - new_w) / 2, (new_shape - new_h) / 2
    left, top = round(dw - 0.1), round(dh - 0.1)
    return r, (new_w, new_h), (left, top)


def letterbox(
    frames: torch.Tensor,
    new_shape: int = 640,
    pad_value: float = 114.0 / 255.0,
    scaleup: bool = True,
    bgr_to_rgb: bool = False,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """Letterbox a batch of frames.

    frames: (B, H, W, C) uint8, or float in [0, 1].  Returns (images
    (B, new, new, C) ``dtype`` in [0, 1], ratio r, (pad_left, pad_top)).  An
    exact integer downscale (720p → 640²: n = 2; 1080p: n = 3) applies cv2's 1-2
    taps per axis; other ratios use cv2's half-pixel 2-tap interpolation as two
    matmuls.
    """
    B, H, W, C = frames.shape
    r, (new_w, new_h), (left, top) = letterbox_params(H, W, new_shape, scaleup)
    scale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
    n = int(round(1.0 / r)) if r > 0 else 0
    exact_int_down = (
        r < 1.0 and n >= 1 and H == new_h * n and W == new_w * n and abs(r * n - 1.0) < 1e-9
    )
    if (new_h, new_w) == (H, W):
        x = frames.to(dtype)
        x = x / 255.0 if frames.dtype == torch.uint8 else x
    elif exact_int_down:
        x = frames.reshape(B, new_h, n, new_w, n, C)
        taps = _cv2_linear_taps(n)
        # the W taps carry 1/255 and are rounded to ``dtype`` (the JAX package's
        # lane-mix matrix); its two orders of the taps are followed, since in bf16
        # they round differently
        wt_w = [(d, _round(wt * scale, dtype)) for d, wt in taps]
        if (new_w * C) % _MIX_OUT_BLOCK == 0:
            # W taps first, then H taps, all summed in fp32
            x = sum(wh * sum(ww * x[:, :, dh, :, dw].float() for dw, ww in wt_w) for dh, wh in taps)
        else:
            # H taps first in ``dtype``, then the W taps summed in fp32
            rows = sum(wh * x[:, :, dh].to(dtype) for dh, wh in taps)
            x = sum(ww * rows[:, :, :, dw].float() for dw, ww in wt_w)
        x = x.to(dtype)
    else:
        mh = torch.from_numpy(_interp_matrix(H, new_h)).to(device=frames.device, dtype=dtype)
        mw = torch.from_numpy(_interp_matrix(W, new_w)).to(device=frames.device, dtype=dtype)
        x = frames.to(dtype)
        x = x / 255.0 if frames.dtype == torch.uint8 else x
        # two contractions, each summed in fp32 and rounded to ``dtype``
        x = torch.einsum("bhwc,hH->bHwc", x, mh).to(dtype)
        x = torch.einsum("bHwc,wW->bHWc", x, mw).to(dtype)
    if bgr_to_rgb:
        x = x.flip(-1)
    out = torch.full((B, new_shape, new_shape, C), pad_value, dtype=torch.float32, device=x.device).to(dtype)
    out[:, top:top + new_h, left:left + new_w] = x
    return out, r, (left, top)


def _round(v: float, dtype: torch.dtype) -> float:
    """``v`` as fp32 rounded to ``dtype`` (a weight of the JAX package's fp32
    numpy matrices cast to the compute type)."""
    return float(torch.tensor(v, dtype=torch.float32).to(dtype))


def scale_boxes(boxes: torch.Tensor, r: float, pad: Tuple[int, int],
                orig_hw: Tuple[int, int]) -> torch.Tensor:
    """xyxy boxes in letterboxed-image pixels → original frame pixels, clipped."""
    left, top = pad
    h, w = orig_hw
    shift = boxes.new_tensor([left, top, left, top])
    lim = boxes.new_tensor([w, h, w, h])
    return torch.minimum(((boxes - shift) / r).clamp(min=0), lim)


def scale_coords(coords: torch.Tensor, r: float, pad: Tuple[int, int],
                 orig_hw: Tuple[int, int]) -> torch.Tensor:
    """(…, 2) xy points in letterboxed-image pixels → original frame pixels, clipped."""
    left, top = pad
    h, w = orig_hw
    out = (coords - coords.new_tensor([left, top])) / r
    return torch.minimum(out.clamp(min=0), coords.new_tensor([w, h]))
