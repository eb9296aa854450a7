"""int8 convolutions for serving: the port's counterpart of ``yolo_puncture_tpu/nn/quant.py``.

``with int8_convs(): model(x)`` runs every eligible convolution as an
s8×s8→s32 product: each ``ConvBN``'s convolution with ``groups == 1`` (the
backbone's, the neck's and the heads' hidden layers).  The biased prediction
layers of the heads, depthwise and grouped convolutions and the Proto's
``ConvTranspose2d`` stay in floating point, as in the JAX package.

  * activations are quantised per tensor: dynamically, ``absmax / 127`` over
    the whole batch on the device, or with a static scale from
    ``collect_act_scales`` (``max(scale, 1e-8) / 127`` in Python doubles,
    rounded to fp32);
  * weights per output channel: ``max |k|`` over (in, kh, kw), at least 1e-12,
    over 127, from fp32 weights: the JAX package quantises flax's fp32
    parameters whatever the compute type, so a model that will compute in bf16
    has its int8 weights taken by ``freeze_int8_weights`` while it is still
    fp32 (``YOLO(int8_serving=True)`` and the bench do); a bf16 convolution
    without them, or one whose weights changed since, raises;
  * ``round(v / s)`` rounds half to even and is clipped to ±127; ``s`` is a
    tensor on the value's device, never a Python number, because PyTorch's CUDA
    division by a host scalar multiplies by the reciprocal, which can move a
    value across a rounding tie where JAX's division does not.  A division by
    the constant 127, on the other hand, XLA folds into a product with the fp32
    reciprocal, and so does the port (``RCP127``): the int8 operands then equal
    those of the jitted JAX package, which is how its predictor, bench and
    tracker run;
  * the int32 result is dequantised by ``y · (sx · sk)`` in fp32 and rounded to
    the convolution's type; BatchNorm and SiLU follow unchanged.

The JAX package computes these products with XLA ops
(``lax.conv_general_dilated`` with ``preferred_element_type=int32``), not with a
Pallas kernel, so the port computes them with PyTorch calls: an im2col of the
int8 activation in channels-last order and ``torch._int_mm`` (cuBLASLt's
s8×s8→s32 on the card).  ``int_mm`` pads the operands to the card's shape rules
(more than 16 rows, inner and outer widths multiples of 8) with zeros, which
is exact.

The switch is thread-local: ``int8_convs`` in one thread does not reach a model
running in another (the server's batcher, the web UI).  Convolutions are keyed
by the flax module path the JAX package's ``_module_key`` gives
(``model_2/m_0/cv1/conv``; ``YOLOModel`` sets ``flax_path`` on its
convolutions), so an ``act_scales`` dict made by either package works in the
other.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_STATE = threading.local()


def _mode():
    """None, ``("int8", act_scales)`` or ``("record", scales, percentile)``."""
    return getattr(_STATE, "mode", None)


@contextlib.contextmanager
def _switched(mode):
    before = _mode()
    _STATE.mode = mode
    try:
        yield
    finally:
        _STATE.mode = before


# XLA folds a division by a constant into a product with its fp32 reciprocal, so
# the JAX package's jitted ``absmax / 127.0`` is ``absmax · fp32(1/127)``
RCP127 = float(np.float32(1.0) / np.float32(127.0))


def quantize(x: torch.Tensor, scale: torch.Tensor, lo: int = -127) -> torch.Tensor:
    """``clip(round(x / scale), lo, 127)`` as int8, in fp32 (``scale`` a tensor
    that broadcasts)."""
    return torch.div(x.float(), scale).round_().clamp_(lo, 127).to(torch.int8)


def absmax_scale(x: torch.Tensor, eps: float = 1e-8, dim=None) -> torch.Tensor:
    """``max(max |x|, eps) / 127`` in fp32 as the jitted JAX package computes it,
    over all of ``x`` or over ``dim``."""
    if dim is None:
        lo, hi = torch.aminmax(x)                     # one pass in x's own type, exact
        m = torch.maximum(lo.neg(), hi).float()
    else:
        m = x.float().abs().amax(dim=dim)
    return m.clamp_min(eps) * RCP127


def static_scale(act_scale: float) -> float:
    """A calibrated activation scale → its quantisation step, ``max(scale,
    1e-8) / 127`` in Python doubles rounded to fp32, as the JAX package's."""
    return float(np.float32(max(float(act_scale), 1e-8) / 127.0))


def quantize_activation(x: torch.Tensor, act_scale: Optional[float] = None):
    """An activation → (int8 tensor, fp32 0-dim scale): one scale for the whole
    tensor, dynamic (``absmax / 127``) or static (``act_scale``)."""
    if act_scale is None:
        sx = absmax_scale(x)
    else:
        sx = torch.full((), static_scale(act_scale), dtype=torch.float32, device=x.device)
    return quantize(x, sx), sx


def quantize_weight(w: torch.Tensor):
    """A kernel (O, I, kh, kw) → (int8 kernel, fp32 scale per output channel (O,))."""
    sk = absmax_scale(w, 1e-12, dim=(1, 2, 3))
    return quantize(w, sk[:, None, None, None]), sk


def _pad_to(n: int, multiple: int, least: int = 0) -> int:
    return max(-(-n // multiple) * multiple, least)


def int_mm(a: torch.Tensor, b_rows: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ b_rows (N, K)ᵀ`` of int8 → int32 (M, N) through
    ``torch._int_mm``, the operands zero-padded to more than 16 rows and to
    widths that are multiples of 8 (the card's rules), the padding cut off."""
    M, K = a.shape
    N = b_rows.shape[0]
    Mp, Kp, Np = _pad_to(M, 1, 17), _pad_to(K, 8), _pad_to(N, 8)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        b_rows = F.pad(b_rows, (0, Kp - K, 0, Np - N))
    out = torch._int_mm(a.contiguous(), b_rows.contiguous().t())
    return out[:M, :N] if (Mp, Np) != (M, N) else out


def _im2col(xi8: torch.Tensor, kh: int, kw: int, stride, padding, dilation) -> torch.Tensor:
    """int8 NCHW (B, C, H, W) → (B·Ho·Wo, kh·kw·C), columns in (kh, kw, C) order,
    and (Ho, Wo)."""
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    x = F.pad(xi8, (pw, pw, ph, ph)) if ph or pw else xi8
    x = x.permute(0, 2, 3, 1).contiguous()                     # (B, Hp, Wp, C)
    B, Hp, Wp, C = x.shape
    Ho, Wo = (Hp - dh * (kh - 1) - 1) // sh + 1, (Wp - dw * (kw - 1) - 1) // sw + 1
    sB, sH, sW, sC = x.stride()
    cols = x.as_strided((B, Ho, Wo, kh, kw, C), (sB, sH * sh, sW * sw, sH * dh, sW * dw, sC))
    return cols.reshape(B * Ho * Wo, kh * kw * C), (Ho, Wo)


def _kernel_rows(ki8: torch.Tensor) -> torch.Tensor:
    """int8 kernel (O, I, kh, kw) → ``int_mm``'s (O, kh·kw·I) operand."""
    return ki8.permute(0, 2, 3, 1).reshape(ki8.shape[0], -1).contiguous()


def _conv_int32(xi8, krows, kernel_size, stride, padding, dilation) -> torch.Tensor:
    a, (Ho, Wo) = _im2col(xi8, *kernel_size, stride, padding, dilation)
    O = krows.shape[0]
    return int_mm(a, krows).view(xi8.shape[0], Ho, Wo, O).permute(0, 3, 1, 2)


def conv2d_int8(xi8: torch.Tensor, ki8: torch.Tensor, stride=(1, 1), padding=(0, 0), dilation=(1, 1)):
    """The s8×s8→s32 convolution: int8 NCHW input, int8 (O, I, kh, kw) kernel →
    int32 (B, O, Ho, Wo) (a channels-last view)."""
    return _conv_int32(xi8, _kernel_rows(ki8), ki8.shape[2:], stride, padding, dilation)


def freeze_int8_weights(model: nn.Module) -> nn.Module:
    """Quantise the weights of every eligible convolution of ``model`` now, and
    keep the int8 kernel (as ``int_mm``'s operand) and its scales for the int8
    path.  The weights must be fp32: call it before casting a model to bf16.
    The operands are non-persistent buffers, so they follow the model to the
    card and stay out of its state dict.  An int8 forward after the weights
    have changed in place (training, a state dict loaded) raises."""
    for m in model.modules():
        if not _eligible(m):
            continue
        if m.weight.dtype != torch.float32:
            raise ValueError(f"freeze_int8_weights quantises fp32 weights; {_name(m)} holds {m.weight.dtype}")
        with torch.no_grad():
            ki8, sk = quantize_weight(m.weight)
        m.register_buffer("int8_kernel", _kernel_rows(ki8), persistent=False)
        m.register_buffer("int8_scale", sk, persistent=False)
        m.int8_weight_version = m.weight._version        # kept by a cast or a move, raised by a write
    return model


def _name(conv: nn.Module) -> str:
    return getattr(conv, "flax_path", type(conv).__name__)


def _weight_operand(conv: nn.Conv2d):
    """The convolution's quantised kernel as ``int_mm``'s (O, kh·kw·I) operand and
    its scales: those ``freeze_int8_weights`` kept, or, for an fp32 convolution
    without them, its weights quantised now."""
    if "int8_kernel" in conv._buffers:
        if conv.weight._version != conv.int8_weight_version:
            raise RuntimeError(f"the weights of {_name(conv)} changed after freeze_int8_weights; freeze them again "
                               "from fp32")
        return conv.int8_kernel, conv.int8_scale
    if conv.weight.dtype != torch.float32:
        raise RuntimeError(f"{_name(conv)} computes in {conv.weight.dtype}, and its int8 weights come from fp32 ones: "
                           "call freeze_int8_weights on the fp32 model before the cast")
    ki8, sk = quantize_weight(conv.weight.detach())
    return _kernel_rows(ki8), sk


def _static_operand(conv: nn.Conv2d, act_scale: float, device: torch.device) -> torch.Tensor:
    """``static_scale(act_scale)`` as a 0-dim fp32 tensor on ``device`` (a divisor
    that stays a division, module docstring), made once per convolution and
    scale."""
    s = static_scale(act_scale)
    held = getattr(conv, "_int8_static", None)
    if held is None or held[0] != s or held[1].device != device:
        held = conv._int8_static = (s, torch.full((), s, dtype=torch.float32, device=device))
    return held[1]


def _int8_conv(conv: nn.Conv2d, x: torch.Tensor, act_scale: Optional[float] = None) -> torch.Tensor:
    """``conv(x)`` as an int8 product (module docstring), in the convolution's type."""
    sx = absmax_scale(x) if act_scale is None else _static_operand(conv, act_scale, x.device)
    xi8 = quantize(x, sx)
    krows, sk = _weight_operand(conv)
    y = _conv_int32(xi8, krows, conv.kernel_size, conv.stride, conv.padding, conv.dilation)
    out = torch.empty(y.shape, dtype=conv.weight.dtype, device=x.device)
    return torch.mul(y, (sx * sk).view(1, -1, 1, 1), out=out)      # fp32 product, rounded to the type


def _eligible(conv: nn.Module) -> bool:
    """The JAX package's set: a convolution without bias, not grouped, with
    numeric padding."""
    return (isinstance(conv, nn.Conv2d) and conv.bias is None and conv.groups == 1
            and not isinstance(conv.padding, str))


def recording() -> bool:
    """Whether ``collect_act_scales`` is recording in this thread."""
    mode = _mode()
    return mode is not None and mode[0] == "record"


def conv_forward(module: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``module(x)``, as the switch of this thread says: fp, int8, or fp while the
    input's scale is recorded."""
    mode = _mode()
    if mode is None or not _eligible(module):
        return module(x)
    if mode[0] == "int8":
        scales = mode[1]
        return _int8_conv(module, x, scales.get(module.flax_path) if scales else None)
    _, scales, percentile = mode
    a = x.detach().float().abs().flatten()
    amax = float(a.max()) if percentile >= 100.0 else percentile_linear(a, percentile)
    scales[module.flax_path] = max(scales.get(module.flax_path, 0.0), amax)
    return module(x)


def percentile_linear(a: torch.Tensor, percentile: float) -> float:
    """``jnp.percentile(a, percentile)`` of a flat fp32 tensor, as XLA computes it
    on the CPU: the position ``q · (n − 1)`` with its constants folded,
    ``fp32(percentile) · fp32(fp32(1/100) · fp32(n − 1))``, and the two
    neighbouring order statistics mixed as ``fma(high, w, low · (1 − w))``.  The
    neighbours come from one ``topk`` of the values from the lower one up (a
    calibration's percentile sits in the top tail): no sort, and no
    ``torch.quantile`` limit of 2²⁴ elements."""
    f = np.float32
    n = a.numel()
    pos = f(f(percentile) * f(f(f(1.0) / f(100.0)) * f(n - 1)))
    lo = int(min(max(np.floor(pos), 0), n - 1))
    hi = int(min(max(np.ceil(pos), 0), n - 1))
    hw = f(pos - f(np.floor(pos)))
    top = torch.topk(a, n - lo).values                  # descending: top[-1] is order statistic lo
    v_lo = f(top[-1].item())
    v_hi = v_lo if hi == lo else f(top[-2].item())
    return float(f(np.float64(f(v_lo * f(f(1.0) - hw))) + np.float64(v_hi) * np.float64(hw)))


@contextlib.contextmanager
def int8_convs(enabled: bool = True, act_scales: Optional[dict] = None):
    """Inside the block, in this thread, eligible convolutions run in int8.
    ``act_scales`` (from ``collect_act_scales``) gives static activation scales
    by module path; a convolution missing from it, or every one without it,
    takes a dynamic scale from its input."""
    if not enabled:
        yield
        return
    with _switched(("int8", act_scales)):
        yield


def collect_act_scales(apply_fn: Callable, batches: Iterable, percentile: float = 99.9) -> dict:
    """Calibration: ``apply_fn(batch)`` for each batch, recording the inputs of
    the eligible convolutions.  Returns ``{module path: amax}``, the max over
    batches of each batch's ``percentile`` of ``|x|`` (``percentile >= 100``: the
    plain abs-max).  The convolutions run in fp meanwhile; the outputs are
    unchanged."""
    scales: dict = {}
    with _switched(("record", scales, float(percentile))), torch.no_grad():
        for batch in batches:
            apply_fn(batch)
    return scales
