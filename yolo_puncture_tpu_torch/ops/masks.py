"""Proto-mask decode and the mask resamplers.

Counterpart of ``yolo_puncture_tpu/ops/masks.py``.  ``decode_masks`` at proto
resolution (``upsample=False``, the predictor's path) is one call of the
hand-written CUDA kernel ``ops/kernels/proto_decode.py`` on CUDA tensors (the
JAX predictor computes the same function through XLA).  The resamplers are
matmuls with precomputed interpolation weights.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from yolo_puncture_tpu_torch.ops.kernels.proto_decode import box_inside, proto_decode


@lru_cache(maxsize=8)
def _interp_matrix(src: int, dst: int, window=None) -> np.ndarray:
    """(src, dst) bilinear interpolation matrix with half-pixel centres (cv2 /
    jax.image.resize sampling for upscaling).  ``window=(lo, hi)`` samples only
    that source span (fractional allowed).  Cached; callers must not write to it."""
    lo, hi = (0.0, float(src)) if window is None else (float(window[0]), float(window[1]))
    M = np.zeros((src, dst), np.float32)
    scale = (hi - lo) / dst
    for j in range(dst):
        x = lo + (j + 0.5) * scale - 0.5
        i0 = int(np.floor(x))
        f = x - i0
        i0c, i1c = np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1)
        M[i0c, j] += 1.0 - f
        M[i1c, j] += f
    return M


@lru_cache(maxsize=32)
def interp_matrix_on(src: int, dst: int, window, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``_interp_matrix`` as a tensor on ``device``, made once per geometry
    (cached; callers must not write to it)."""
    return torch.from_numpy(_interp_matrix(src, dst, window)).to(device=device, dtype=dtype)


def _first_axis(h: int, w: int, H: int, W: int) -> str:
    """Which axis a separable resample of (…, h, w) to (…, H, W) contracts first:
    the order of least multiply-adds, "h" on a tie.  It is the path the JAX
    package's einsums take (opt_einsum's 'optimal' path for three operands),
    which matters where the intermediate is rounded to bf16."""
    return "h" if H * h * w + H * w * W <= h * w * W + H * h * W else "w"


def _resample(x: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """(…, h, w) → (…, H, W) through mh (h, H) and mw (w, W) in x's type, each
    contraction summed in fp32 and rounded to that type."""
    h, w = x.shape[-2:]
    if _first_axis(h, w, mh.shape[1], mw.shape[1]) == "h":
        return torch.matmul(torch.matmul(mh.T, x), mw)
    return torch.matmul(mh.T, torch.matmul(x, mw))


def upsample_bilinear_matmul(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(…, h, w) → (…, H, W) bilinear upsample as two matmuls, in x's type."""
    h, w = x.shape[-2:]
    mh = interp_matrix_on(h, H, None, x.device, x.dtype)
    mw = interp_matrix_on(w, W, None, x.device, x.dtype)
    if x.dtype == torch.float32:
        return torch.matmul(mh.T, torch.matmul(x, mw))
    # the JAX package contracts h first and rounds in between
    return torch.matmul(torch.matmul(mh.T, x), mw)


def crop_masks(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero mask pixels outside each instance's box.
    masks (B, N, H, W); boxes (B, N, 4) xyxy in mask pixels, half-open; the
    comparison in the masks' type (bf16 pixel coordinates above 256 are rounded,
    as ``jnp.arange(H, dtype=bfloat16)`` rounds them)."""
    H, W = masks.shape[-2:]
    return masks * box_inside(boxes.to(masks.dtype), H, W).to(masks.dtype)


def decode_masks(
    protos: torch.Tensor,
    coeffs: torch.Tensor,
    boxes: torch.Tensor,
    img_hw: Tuple[int, int],
    upsample: bool = True,
    threshold: Optional[float] = 0.5,
    crop: bool = True,
) -> torch.Tensor:
    """Decode instance masks, in bf16 for bf16 prototypes and fp32 otherwise.

    protos (B, Hp, Wp, nm) (the head's layout); coeffs (B, N, nm); boxes
    (B, N, 4) xyxy in letterboxed-image pixels; img_hw the letterboxed size.
    ``upsample=False`` decodes at proto resolution in one kernel call (boxes are
    scaled to proto pixels first, as the JAX package does); ``upsample=True``
    (retina) upsamples sigmoid(logits) to img_hw before crop and threshold.
    Returns (B, N, Hp, Wp) or (B, N, H, W), {0, 1} when ``threshold`` else [0, 1].
    """
    B, Hp, Wp, nm = protos.shape
    H, W = img_hw
    dtype = torch.bfloat16 if protos.dtype == torch.bfloat16 else torch.float32
    protos_cf = protos.permute(0, 3, 1, 2).to(dtype).contiguous()  # a view of the head's NCHW bank
    coeffs = coeffs.to(dtype).contiguous()
    # bf16 boxes are rounded as the reference casts them; the kernel takes them as fp32
    # (and contiguous: a slice of the selected slots is strided)
    boxes = boxes.to(dtype)
    if upsample and (Hp, Wp) != (H, W):
        masks = upsample_bilinear_matmul(proto_decode(protos_cf, coeffs, boxes.float().contiguous(), None,
                                                      crop=False), H, W)
        if crop:
            masks = crop_masks(masks, boxes)
        if threshold is not None:
            masks = (masks > threshold).to(dtype)
        return masks
    scale = boxes.new_tensor([Wp / W, Hp / H, Wp / W, Hp / H])
    return proto_decode(protos_cf, coeffs, (boxes * scale).float().contiguous(), threshold, crop)


@lru_cache(maxsize=16)
def _linear_weight_mat(in_size: int, out_size: int, scale: float, translation: float,
                       device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(in, out) resampling weights of ``jax.image.scale_and_translate(method="linear")``
    (``compute_weight_mat`` in jax/_src/image/scale.py): a triangle kernel widened by
    max(1/scale, 1) when downscaling (antialias), columns normalised, and samples
    that fall outside the input zeroed.  Computed in fp32 as JAX does (in float64
    with ``dtype``, as JAX does with 64-bit floats enabled), on the host, once per
    geometry (cached; callers must not write to it)."""
    f32 = dtype
    inv_scale = 1.0 / torch.tensor(scale, dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=f32) + 0.5) * inv_scale
                - torch.tensor(translation, dtype=f32) * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def paste_masks_to_original(
    masks: torch.Tensor, r: float, pad: Tuple[float, float], orig_hw: Tuple[int, int]
) -> torch.Tensor:
    """Undo the letterbox on decoded masks: one linear resample to the original frame.

    masks (B, N, H, W) at letterbox or proto resolution; ``r`` the mask-to-
    original scale and ``pad`` (left, top) at mask resolution, both possibly
    fractional (the stride-4 proto path passes r/4 and pad/4; rounding the pad
    would shift masks by up to 2 original pixels).  Output centre (i + 0.5)
    reads mask coordinate (i + 0.5)·r + pad.  Returns (B, N, h0, w0) in the
    masks' type when it is bf16 (the weights rounded to bf16, as
    ``jax.image.scale_and_translate`` samples a bf16 input), fp32 otherwise."""
    H, W = masks.shape[-2:]
    left, top = pad
    h0, w0 = orig_hw
    # scale_and_translate's scale = 1/r, translation = −pad/r (float32 parameters)
    s = float(np.float32(1.0 / r))
    wh = _linear_weight_mat(H, h0, s, float(np.float32(-top / r)), masks.device)
    ww = _linear_weight_mat(W, w0, s, float(np.float32(-left / r)), masks.device)
    if masks.dtype == torch.bfloat16:
        return _resample(masks, wh.to(masks.dtype), ww.to(masks.dtype))
    return torch.matmul(wh.T, torch.matmul(masks.float(), ww))
