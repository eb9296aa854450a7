"""Fused proto-mask decode: hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``yolo_puncture_tpu/ops/pallas/proto_decode.py`` (``_kernel`` /
``proto_decode_pallas``).  Per frame, instance and proto pixel it computes
``sigmoid(coeffs @ protos)``, zeroes pixels outside the box (half-open in proto
pixels: ``x1 <= px < x2``, ``y1 <= py < y2``) when ``crop``, and binarises with
``> threshold`` when a threshold is given.  Output ``(B, N, Hp, Wp)`` in the
protos' type: fp32, or bf16 from bf16 protos and coefficients (the products
and the sigmoid in fp32, the sigmoid rounded to bf16 before the crop and the
threshold, as the JAX package's ``decode_masks`` orders them for a bf16 model).

The kernel lives in ``csrc/proto_decode.cu``; its header states the bound
(memory: 3.28 MB read + 3.28 MB written per serving frame, about 2 us at
3.35 TB/s) and the design (four pixels a thread, 16-byte loads and stores,
float4 coefficient broadcasts).  For a threshold inside (0, 1) the kernel does
not take the sigmoid at all: ``sigmoid(x) > t`` is ``x > logit(t)``, and
``threshold_logit`` computes the right-hand side once on the host in float64.
On a CPU tensor the wrapper runs ``proto_decode_reference``; on a CUDA tensor
it launches the kernel or raises: bf16 operands go to the bf16 kernel
(``proto_decode_bf16``), never through an fp32 copy.
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
    boxes (B, N, 4) xyxy in proto pixels → (B, N, Hp, Wp) in the protos' type
    (fp32 or bf16): fp32 products and sigmoid, rounded to that type, then the
    crop and the threshold."""
    B, nm, Hp, Wp = protos.shape
    logits = torch.matmul(coeffs.float(), protos.float().reshape(B, nm, Hp * Wp))
    masks = torch.sigmoid(logits).reshape(B, -1, Hp, Wp).to(protos.dtype)
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
def kernel_fn(dtype: torch.dtype = torch.float32):
    """The C entry point for ``dtype``, ``proto_decode_f32`` or
    ``proto_decode_bf16`` (built on first use), argtypes set."""
    lib = _build.load("proto_decode")
    fn = {torch.float32: lib.proto_decode_f32, torch.bfloat16: lib.proto_decode_bf16}[dtype]
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_args(protos, coeffs, boxes, out, threshold, crop):
    """Arguments of ``kernel_fn(protos.dtype)`` for checked tensors, on the
    current stream.  A bf16 mask is thresholded after its sigmoid is rounded,
    so the bf16 kernel never compares logits, and against the threshold rounded
    to bf16, as ``bf16_tensor > threshold`` rounds a Python float in PyTorch and
    in JAX."""
    B, nm, Hp, Wp = protos.shape
    bf16 = protos.dtype == torch.bfloat16
    logit = None if bf16 else threshold_logit(threshold)
    if threshold is None:
        mode, level = MODE_SOFT, 0.0
    elif logit is None:
        level = float(torch.tensor(threshold, dtype=torch.bfloat16)) if bf16 else float(threshold)
        mode = MODE_SIGMOID_THRESHOLD
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
    """protos (B, nm, Hp, Wp) channel-first and contiguous; coeffs (B, N, nm) of
    the protos' type; boxes (B, N, 4) fp32 xyxy in proto pixels.  Returns
    (B, N, Hp, Wp) in the protos' type, fp32 or bf16.

    CPU tensors take the plain version; CUDA tensors launch the kernel for their
    type (contiguous, nm == 32; ``launches`` counts fp32 launches and
    ``launches_bf16`` bf16 ones) and anything else raises."""
    _check(protos, coeffs, boxes)
    if protos.device.type == "cpu":
        return proto_decode_reference(protos, coeffs, boxes, threshold, crop)
    if protos.device.type != "cuda":
        raise ValueError(f"proto_decode runs on cpu or cuda, not {protos.device}")
    dtype = protos.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"proto_decode kernel takes fp32 or bf16 protos, got {dtype}")
    for name, t, want in (("protos", protos, dtype), ("coeffs", coeffs, dtype), ("boxes", boxes, torch.float32)):
        if t.dtype != want:
            raise TypeError(f"proto_decode kernel takes {str(want)[6:]} {name} with {str(dtype)[6:]} protos, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"proto_decode kernel takes contiguous {name}")
    B, nm, Hp, Wp = protos.shape
    N = coeffs.shape[1]
    if nm != 32:
        raise ValueError(f"proto_decode kernel is compiled for nm == 32, got {nm}")
    if B > 65535:
        raise ValueError(f"proto_decode kernel takes at most 65535 frames, got {B}")
    out = torch.empty((B, N, Hp, Wp), dtype=dtype, device=protos.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(protos.device):
        rc = kernel_fn(dtype)(*kernel_args(protos, coeffs, boxes, out, threshold, crop))
    if rc != 0:
        raise RuntimeError(f"proto_decode kernel launch failed: {_build.error_string('proto_decode', rc)}")
    if dtype == torch.float32:
        proto_decode.launches += 1
    else:
        proto_decode.launches_bf16 += 1
    return out


proto_decode.launches = 0       # fp32 kernel launches since the last reset
proto_decode.launches_bf16 = 0  # bf16 kernel launches since the last reset
