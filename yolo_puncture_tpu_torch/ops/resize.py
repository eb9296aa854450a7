"""Image resizes: cv2's arithmetic without cv2, and ``jax.image.resize``'s.

The JAX package's tracker resizes frames with ``cv2.resize(INTER_LINEAR)`` and
id masks with ``cv2.resize(INTER_NEAREST)`` on the host.  The port runs where
cv2 may be missing, and gives the same pixels:

  * ``resize_linear_u8``: cv2's fixed-point bilinear for uint8 images.  Source
    position of destination pixel d is (d + 0.5)·scale − 0.5, taken in float32;
    the two tap weights are rounded to 11-bit integers (× 2048, ties to even);
    rows are filtered horizontally into 32-bit integers, then vertically as
    ``(((b0·(S0 >> 4)) >> 16) + ((b1·(S1 >> 4)) >> 16) + 2) >> 2``.  Horizontal
    taps that fall off the image snap to the border pixel with weight one;
    vertical taps clamp their row.  An exact 2× shrink on both axes is cv2's
    2×2 box average, ``(a + b + c + d + 2) >> 2``.
  * ``resize_linear_f32``: cv2's INTER_LINEAR for float32 images, which takes
    the source position in double and keeps the tap weights as floats
    (1 − f, f); it filters rows, then columns, in float32, with the border
    rules above.  An exact 2×
    shrink is again cv2's 2×2 box average.
  * ``resize_nearest``: source index ``min(floor(d·scale), src − 1)``.

The JAX package's bench and ``build_bench_tracker`` feed the tracker through
``jax.image.resize(frames_bf16, (B, 480, 864, 3), "bilinear")`` instead, a
different function: ``resize_bilinear`` is its counterpart.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from yolo_puncture_tpu_torch.ops.masks import _linear_weight_mat, _resample

_COEF_BITS = 11
_COEF_ONE = 1 << _COEF_BITS


def _source_taps(src: int, dst: int, snap_border: bool):
    """cv2's linear taps as numpy: (index of tap 0, index of tap 1, fraction f
    of tap 1 in float32) per destination pixel.  ``snap_border`` is the
    horizontal rule (a tap off the image takes the border pixel with weight one);
    without it the indices are clamped and the weights kept (the vertical rule)."""
    scale = 1.0 / (dst / src)                                   # double, as cv2 computes it
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if snap_border:
        f = np.where((s < 0) | (s >= src - 1), np.float32(0), f)
        s = np.clip(s, 0, src - 1)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f


@lru_cache(maxsize=32)
def _linear_taps(src: int, dst: int, snap_border: bool, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(index of tap 0, index of tap 1, weight 0, weight 1) per destination
    pixel on ``device``, weights as cv2's 11-bit integers (``_source_taps``).
    Made once per geometry (cached; callers must not write to them)."""
    i0, i1, f = _source_taps(src, dst, snap_border)
    w1 = np.rint(f * np.float32(_COEF_ONE)).astype(np.int32)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_ONE)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (i0, i1, w0, w1))


@lru_cache(maxsize=32)
def _linear_taps_f32(src: int, dst: int, snap_border: bool, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The taps of cv2's float images: positions and fraction f in double, the
    weights (1 − f, f) rounded to float32; the border rules of ``_source_taps``."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    if snap_border:
        f = np.where((s < 0) | (s >= src - 1), 0.0, f)
        s = np.clip(s, 0, src - 1)
    i0, i1 = np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1)
    return tuple(torch.from_numpy(a).to(device) for a in (i0, i1, (1.0 - f).astype(np.float32), f.astype(np.float32)))


def resize_linear_u8(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(H, W, C) uint8 → (h, w, C) uint8 with ``cv2.resize(..., INTER_LINEAR)``'s
    pixels, on the tensor's device."""
    if img.dtype != torch.uint8 or img.dim() != 3:
        raise ValueError(f"resize_linear_u8 takes an (H, W, C) uint8 image, got {tuple(img.shape)} {img.dtype}")
    H, W, _ = img.shape
    h, w = out_hw
    if (H, W) == (h, w):
        return img
    x = img.to(torch.int32)
    if H == 2 * h and W == 2 * w:                               # cv2 takes its box filter here
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).to(torch.uint8)
    xi0, xi1, xw0, xw1 = _linear_taps(W, w, True, img.device)
    yi0, yi1, yw0, yw1 = _linear_taps(H, h, False, img.device)
    rows = x[:, xi0] * xw0[None, :, None] + x[:, xi1] * xw1[None, :, None]      # (H, w, C), × 2048
    top = (yw0[:, None, None] * (rows[yi0] >> 4)) >> 16
    bot = (yw1[:, None, None] * (rows[yi1] >> 4)) >> 16
    return ((top + bot + 2) >> 2).clamp_(0, 255).to(torch.uint8)


def resize_linear_f32(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(H, W) or (H, W, C) float32 → (h, w[, C]) float32 with
    ``cv2.resize(..., INTER_LINEAR)``'s weights, on the tensor's device."""
    if img.dtype != torch.float32 or img.dim() not in (2, 3):
        raise ValueError(f"resize_linear_f32 takes an (H, W[, C]) float32 image, got {tuple(img.shape)} {img.dtype}")
    x = img if img.dim() == 3 else img[..., None]
    H, W, _ = x.shape
    h, w = out_hw
    if (H, W) == (h, w):
        return img
    if H == 2 * h and W == 2 * w:                               # cv2 takes its box filter here
        out = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]) * 0.25
    else:
        xi0, xi1, xw0, xw1 = _linear_taps_f32(W, w, True, img.device)
        yi0, yi1, yw0, yw1 = _linear_taps_f32(H, h, False, img.device)
        rows = x[:, xi0] * xw0[None, :, None] + x[:, xi1] * xw1[None, :, None]    # (H, w, C)
        out = rows[yi0] * yw0[:, None, None] + rows[yi1] * yw1[:, None, None]
    return out if img.dim() == 3 else out[..., 0]


def resize_nearest(a: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(H, W) array → (h, w) with ``cv2.resize(..., INTER_NEAREST)``'s sampling."""
    H, W = a.shape[:2]
    h, w = out_hw
    if (H, W) == (h, w):
        return a
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(np.int64), H - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(np.int64), W - 1)
    return a[ys[:, None], xs[None, :]]


def resize_bilinear(images: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(images, (B, h, w, C), "bilinear")`` of NHWC float
    images, in their own type.  That is ``scale_and_translate``'s antialiased
    triangle (widened by the shrink factor when downscaling: 720 → 480 averages
    over 1.5 source pixels, unlike cv2's INTER_LINEAR), with the weights of
    ``ops/masks.py _linear_weight_mat`` rounded to the images' type, and the two
    contractions each summed in fp32 and rounded to that type, in the order
    XLA's einsum takes them.  float64 images get float64 scales and weights, as
    JAX computes them with 64-bit floats enabled.  (B, H, W, C) → (B, h, w, C),
    a channels-last view of a (B, C, h, w) tensor."""
    B, H, W, C = images.shape
    h, w = out_hw
    if images.dtype == torch.float64:           # JAX with 64-bit floats: scales and weights in float64
        wh = _linear_weight_mat(H, h, h / H, 0.0, images.device, torch.float64)
        ww = _linear_weight_mat(W, w, w / W, 0.0, images.device, torch.float64)
    else:
        wh = _linear_weight_mat(H, h, float(np.float32(h / H)), 0.0, images.device).to(images.dtype)
        ww = _linear_weight_mat(W, w, float(np.float32(w / W)), 0.0, images.device).to(images.dtype)
    return _resample(images.permute(0, 3, 1, 2), wh, ww).permute(0, 2, 3, 1)
