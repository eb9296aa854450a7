"""Fused proto-mask decode: hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``yolo_puncture_tpu/ops/pallas/proto_decode.py`` (``_kernel`` /
``proto_decode_pallas``).  Per frame, instance and proto pixel it computes
``sigmoid(coeffs @ protos)``, zeroes pixels outside the box (half-open in proto
pixels: ``x1 <= px < x2``, ``y1 <= py < y2``) when ``crop``, and binarises with
``> threshold`` when a threshold is given.  Output is fp32 ``(B, N, Hp, Wp)``.

The kernel lives in ``csrc/proto_decode.cu``; its header states the bound
(memory: 3.28 MB read + 3.28 MB written per serving frame, about 2 us at
3.35 TB/s) and the design (four pixels a thread, 16-byte loads and stores,
float4 coefficient broadcasts).  For a threshold inside (0, 1) the kernel does
not take the sigmoid at all: ``sigmoid(x) > t`` is ``x > logit(t)``, and
``threshold_logit`` computes the right-hand side once on the host in float64.
On a CPU tensor the wrapper runs ``proto_decode_reference``; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Optional

import torch

from yolo_puncture_tpu_torch import _build


def proto_decode_reference(
    protos: torch.Tensor,
    coeffs: torch.Tensor,
    boxes: torch.Tensor,
    threshold: Optional[float] = None,
    crop: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version.  protos (B, nm, Hp, Wp); coeffs (B, N, nm);
    boxes (B, N, 4) xyxy in proto pixels → (B, N, Hp, Wp) fp32."""
    B, nm, Hp, Wp = protos.shape
    logits = torch.matmul(coeffs.float(), protos.float().reshape(B, nm, Hp * Wp))
    masks = torch.sigmoid(logits).reshape(B, -1, Hp, Wp)
    if crop:
        masks = masks * box_inside(boxes.float(), Hp, Wp).to(masks.dtype)
    if threshold is not None:
        masks = (masks > threshold).to(masks.dtype)
    return masks


def box_inside(boxes: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, N, H, W) bool: pixel (x, y) lies in the half-open box [x1, x2) × [y1, y2)."""
    ys = torch.arange(H, dtype=boxes.dtype, device=boxes.device)[None, None, :, None]
    xs = torch.arange(W, dtype=boxes.dtype, device=boxes.device)[None, None, None, :]
    x1, y1, x2, y2 = (boxes[..., i, None, None] for i in range(4))
    return (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)


MODE_SOFT, MODE_SIGMOID_THRESHOLD, MODE_LOGIT_THRESHOLD = 0, 1, 2  # the kernel's ``mode`` argument


def threshold_logit(threshold: Optional[float]) -> Optional[float]:
    """``logit(t)`` in float64 for a threshold strictly inside (0, 1), else None:
    there ``sigmoid(x) > t`` is ``x > logit(t)`` and the kernel skips the sigmoid.
    Outside (0, 1) (and for no threshold) the kernel keeps the sigmoid, whose fp32
    saturation at 0 and 1 decides those comparisons."""
    if threshold is None or not 0.0 < threshold < 1.0:
        return None
    return math.log(threshold) - math.log1p(-threshold)


@lru_cache(maxsize=None)
def kernel_fn():
    """The C entry point ``proto_decode_f32`` (built on first use), argtypes set."""
    fn = _build.load("proto_decode").proto_decode_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_args(protos, coeffs, boxes, out, threshold, crop):
    """Arguments of ``kernel_fn()`` for checked tensors, on the current stream."""
    B, nm, Hp, Wp = protos.shape
    logit = threshold_logit(threshold)
    if threshold is None:
        mode, level = MODE_SOFT, 0.0
    elif logit is None:
        mode, level = MODE_SIGMOID_THRESHOLD, float(threshold)
    else:
        mode, level = MODE_LOGIT_THRESHOLD, logit
    return (
        protos.data_ptr(), coeffs.data_ptr(), boxes.data_ptr(), out.data_ptr(),
        B, coeffs.shape[1], nm, Hp, Wp, int(crop), mode, level,
        torch.cuda.current_stream(protos.device).cuda_stream,
    )


def _check(protos, coeffs, boxes):
    if protos.dim() != 4 or coeffs.dim() != 3 or boxes.dim() != 3:
        raise ValueError("proto_decode wants protos (B, nm, Hp, Wp), coeffs (B, N, nm), boxes (B, N, 4)")
    B, nm = protos.shape[:2]
    N = coeffs.shape[1]
    if tuple(coeffs.shape) != (B, N, nm) or tuple(boxes.shape) != (B, N, 4):
        raise ValueError(
            f"shape mismatch: protos {tuple(protos.shape)}, coeffs {tuple(coeffs.shape)}, "
            f"boxes {tuple(boxes.shape)}"
        )
    for name, t in (("protos", protos), ("coeffs", coeffs), ("boxes", boxes)):
        if t.device != protos.device:
            raise ValueError(f"{name} is on {t.device}, protos on {protos.device}")


def proto_decode(
    protos: torch.Tensor,
    coeffs: torch.Tensor,
    boxes: torch.Tensor,
    threshold: Optional[float] = None,
    crop: bool = True,
) -> torch.Tensor:
    """protos (B, nm, Hp, Wp) channel-first and contiguous; coeffs (B, N, nm);
    boxes (B, N, 4) xyxy in proto pixels.  Returns (B, N, Hp, Wp) fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel (fp32,
    contiguous, nm == 32) and anything else raises."""
    _check(protos, coeffs, boxes)
    if protos.device.type == "cpu":
        return proto_decode_reference(protos, coeffs, boxes, threshold, crop)
    if protos.device.type != "cuda":
        raise ValueError(f"proto_decode runs on cpu or cuda, not {protos.device}")
    for name, t in (("protos", protos), ("coeffs", coeffs), ("boxes", boxes)):
        if t.dtype != torch.float32:
            raise TypeError(f"proto_decode kernel takes fp32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"proto_decode kernel takes contiguous {name}")
    B, nm, Hp, Wp = protos.shape
    N = coeffs.shape[1]
    if nm != 32:
        raise ValueError(f"proto_decode kernel is compiled for nm == 32, got {nm}")
    if B > 65535:
        raise ValueError(f"proto_decode kernel takes at most 65535 frames, got {B}")
    out = torch.empty((B, N, Hp, Wp), dtype=torch.float32, device=protos.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(protos.device):
        rc = kernel_fn()(*kernel_args(protos, coeffs, boxes, out, threshold, crop))
    if rc != 0:
        raise RuntimeError(f"proto_decode kernel launch failed: {_build.error_string('proto_decode', rc)}")
    proto_decode.launches += 1
    return out


proto_decode.launches = 0  # kernel launches since the last reset
