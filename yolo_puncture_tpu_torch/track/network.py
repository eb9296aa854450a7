"""Propagation network of the mask tracker: key/value encoders, memory readout,
mask decoder (NCHW modules, inference only).

Counterpart of ``yolo_puncture_tpu/track/network.py``.  Modules carry the flax
attribute names (``key_encoder.stem``, ``decoder.dec8`` …) and concatenate
channels in the JAX package's order, so ``utils/convert.py
export_tracker_state_dict`` loads the shipped checkpoints by name.  Tensors are
channel-first here (image (B, 3, H, W), sensory (No, Cs, H16, W16)) where the
JAX package is channel-last; the flat readout functions (query (Q, Ck), keys
(M, Ck), values (No, M, Cv)) and the decode tail's wrapper keep its layouts.

The decode tail of ``MaskDecoder`` is ``ops/kernels/decode_tail.decode_tail``:
the hand-written CUDA kernel on CUDA tensors, its plain version on CPU tensors.
``MaskDecoder.decode_tail_exact`` is the un-packed form
(``MaskDecoder.decode_tail`` of the JAX package), the numerics reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolo_puncture_tpu_torch.nn.common import C2f, ConvBN
from yolo_puncture_tpu_torch.nn.quant import RCP127, absmax_scale, int_mm, quantize
from yolo_puncture_tpu_torch.ops.kernels.decode_tail import (
    DecodeTailParams,
    decode_tail,
    depth_to_space2,
    pack_decode_tail_params,
    subpix_up_weights,
)
from yolo_puncture_tpu_torch.ops.masks import interp_matrix_on, upsample_bilinear_matmul

KEY_DIM = 64
VALUE_DIM = 128
SENSORY_DIM = 64

_subpix_up_weights = subpix_up_weights  # the JAX package's names
_depth_to_space2 = depth_to_space2


def space_to_depth(x: torch.Tensor, r: int = 4) -> torch.Tensor:
    """(B, C, H, W) → (B, C·r², H/r, W/r), output channel (r_h·r + r_w)·C + c:
    the JAX package's channel-last fold ``(r_h, r_w, C)``, which is the order of
    the stem conv's input channels."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // r, r, W // r, r)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(B, C * r * r, H // r, W // r)


class KeyEncoder(nn.Module):
    """Image → query key (stride 16) and the skip features f4 / f8 / f16."""

    def __init__(self, stage3_n: int = 1):
        super().__init__()
        self.stem = ConvBN(48, 128, 3, 1)
        self.stage1 = C2f(128, 128, 1, True)
        self.down2 = ConvBN(128, 256, 3, 2)
        self.stage2 = C2f(256, 256, 1, True)
        self.down3 = ConvBN(256, 256, 3, 2)
        self.stage3 = C2f(256, 256, stage3_n, True)
        self.key_proj = ConvBN(256, KEY_DIM, 1, 1, act=False)

    def project_key(self, f16):
        return self.key_proj(f16)

    def forward(self, x):
        f4 = self.stage1(self.stem(space_to_depth(x, 4)))
        f8 = self.stage2(self.down2(f4))
        f16 = self.stage3(self.down3(f8))
        return self.key_proj(f16), {"f4": f4, "f8": f8, "f16": f16}


def resize_bilinear(x: torch.Tensor, H: int, W: int, src_window=None) -> torch.Tensor:
    """(…, h, w) → (…, H, W) bilinear resize as two matmuls (the JAX package's
    ``resize_bilinear_nhwc``, on the last two axes).  ``src_window=((rlo, rhi),
    (clo, chi))`` in fractions of the source extent samples only that region."""
    h, w = x.shape[-2:]
    if (h, w) == (H, W) and src_window is None:
        return x
    rw = cw = None
    if src_window is not None:
        (rlo, rhi), (clo, chi) = src_window
        rw, cw = (rlo * h, rhi * h), (clo * w, chi * w)
    mh = interp_matrix_on(h, H, rw, x.device, x.dtype)
    mw = interp_matrix_on(w, W, cw, x.device, x.dtype)
    return torch.matmul(mh.T, torch.matmul(x, mw))


class PyramidAdapter(nn.Module):
    """Detector pyramid {P3, P4, P5} → tracker features {f4, f8, f16}: 1×1
    projections and bilinear resizes onto the tracker's geometry."""

    def __init__(self, pyramid_channels: Tuple[int, int, int] = (128, 256, 512)):
        super().__init__()
        c3, c4, c5 = pyramid_channels
        self.proj4 = ConvBN(c3, 128, 1, 1)
        self.proj8 = ConvBN(c4, 256, 1, 1)
        self.proj16a = ConvBN(c4, 128, 1, 1)   # from P4
        self.proj16b = ConvBN(c5, 128, 1, 1)   # from P5 (context)
        self.fuse16 = ConvBN(256, 256, 3, 1)

    def forward(self, p3, p4, p5, out_hw, content_box=None):
        """p3 (B, C3, H8, W8), p4 (B, C4, H16, W16), p5 (B, C5, H32, W32);
        out_hw = (h16, w16), the tracker's stride-16 grid.  ``content_box`` in
        fractions of the pyramid extent samples only the letterbox content."""
        h16, w16 = out_hw
        f4 = resize_bilinear(self.proj4(p3), 4 * h16, 4 * w16, content_box)
        f8 = resize_bilinear(self.proj8(p4), 2 * h16, 2 * w16, content_box)
        a = resize_bilinear(self.proj16a(p4), h16, w16, content_box)
        b = resize_bilinear(self.proj16b(p5), h16, w16, content_box)
        return {"f4": f4, "f8": f8, "f16": self.fuse16(torch.cat([a, b], 1))}


class ValueEncoder(nn.Module):
    """(image features f16, object mask, sensory) → memory value, per object."""

    def __init__(self, value_dim: int = VALUE_DIM):
        super().__init__()
        self.fuse1 = ConvBN(256 + 1 + SENSORY_DIM, 256, 3, 1)
        self.block = C2f(256, 256, 1, True)
        self.value_proj = ConvBN(256, value_dim, 1, 1, act=False)

    def forward(self, f16, mask_s16, sensory):
        """f16 (C, H16, W16), shared by the objects; mask_s16 (No, 1, H16, W16);
        sensory (No, Cs, H16, W16) → (No, Cv, H16, W16)."""
        f = f16[None].expand(mask_s16.shape[0], -1, -1, -1)
        x = torch.cat([f, mask_s16, sensory], 1)
        return self.value_proj(self.block(self.fuse1(x)))


class SensoryUpdater(nn.Module):
    """GRU-style per-object sensory memory at stride 16; both gates from one conv."""

    def __init__(self, in_dim: int = 128):
        super().__init__()
        self.gates = ConvBN(SENSORY_DIM + in_dim, 2 * SENSORY_DIM, 3, 1, act=False)
        self.cand = ConvBN(SENSORY_DIM + in_dim, SENSORY_DIM, 3, 1, act=False)

    def forward(self, hidden, feat):
        gates = self.gates(torch.cat([hidden, feat], 1))
        z = torch.sigmoid(gates[:, :SENSORY_DIM])
        r = torch.sigmoid(gates[:, SENSORY_DIM:])
        cand = torch.tanh(self.cand(torch.cat([r * hidden, feat], 1)))
        return (1 - z) * hidden + z * cand


class MaskDecoder(nn.Module):
    """(readout value, skips, sensory) → per-object mask logits at stride 4,
    upsampled ×4; soft-aggregated outside."""

    def __init__(self, value_dim: int = VALUE_DIM, in_dim: int = 128, dec_dim: int = 64):
        super().__init__()
        self.skip8 = ConvBN(256, dec_dim, 1, 1)
        self.skip4 = ConvBN(128, dec_dim, 1, 1)
        self.in_conv = ConvBN(value_dim + SENSORY_DIM, in_dim, 3, 1)
        self.dec8 = ConvBN(in_dim, dec_dim, 3, 1)
        self.dec4 = ConvBN(dec_dim, dec_dim, 3, 1)
        self.out = nn.Conv2d(dec_dim, 1, 1)
        # stride-16 mask head on the hidden state: the memory write consumes it
        self.out16 = nn.Conv2d(in_dim, 1, 1)
        self._tail_cache: Dict[tuple, DecodeTailParams] = {}

    def head(self, readout, sensory):
        """readout (No, Cv, H16, W16), sensory (No, Cs, H16, W16) →
        (hidden (No, C, H16, W16), logits_s16 (No, H16, W16)): the part of the
        decoder that depends on the memory."""
        hidden = self.in_conv(torch.cat([readout, sensory], 1))
        return hidden, self.out16(hidden)[:, 0]

    def project_skips(self, skips):
        """1×1 skip projections, independent of the memory and the objects."""
        return {"f8p": self.skip8(skips["f8"]), "f4p": self.skip4(skips["f4"])}

    def tail_params(self, dtype: torch.dtype) -> DecodeTailParams:
        """The tail's packed weights for this activation type, prepared at first
        use and again only after a weight was written or moved."""
        tensors = [self.dec8.conv.weight, self.dec4.conv.weight, self.out.weight, self.out.bias]
        for bn in (self.dec8.bn, self.dec4.bn):
            tensors += [bn.weight, bn.bias, bn.running_mean, bn.running_var]
        key = (dtype, tuple((t.data_ptr(), t._version) for t in tensors))
        if key not in self._tail_cache:
            self._tail_cache.clear()
            self._tail_cache[key] = pack_decode_tail_params(self.dec8, self.dec4, self.out, dtype)
        return self._tail_cache[key]

    def decode_tail(self, hidden, f8p, f4p):
        """hidden (N, No, C, H16, W16) with the frames' projected skips f8p
        (N, Cd, H8, W8), f4p (N, Cd, H4, W4) → stride-4 logits (N, No, H4, W4)
        fp32, through the fused kernel."""
        return decode_tail(
            self.tail_params(hidden.dtype),
            hidden.permute(0, 1, 3, 4, 2).contiguous(),
            f8p.permute(0, 2, 3, 1).contiguous(),
            f4p.permute(0, 2, 3, 1).contiguous(),
        )

    def decode_tail_exact(self, hidden, f8p, f4p):
        """The un-packed tail for one frame, the numerics reference: hidden
        (No, C, H16, W16), f8p (Cd, H8, W8), f4p (Cd, H4, W4) → (No, H4, W4)."""
        def up(x):
            return F.interpolate(x, scale_factor=2, mode="nearest")

        x = self.dec8(up(hidden)) + f8p[None]
        x = self.dec4(up(x)) + f4p[None]
        return self.out(x)[:, 0]

    def forward(self, readout, skips, sensory, full_res: bool = True):
        """One frame.  skips holds f8 / f4 or, already projected, f8p / f4p.
        Returns (logits, hidden, logits_s16); ``full_res=False`` leaves the
        logits at stride 4."""
        hidden, logits_s16 = self.head(readout, sensory)
        f8p = skips["f8p"] if "f8p" in skips else self.skip8(skips["f8"][None])[0]
        f4p = skips["f4p"] if "f4p" in skips else self.skip4(skips["f4"][None])[0]
        logits_s4 = self.decode_tail(hidden[None], f8p[None], f4p[None])[0]
        if not full_res:
            return logits_s4, hidden, logits_s16
        H4, W4 = logits_s4.shape[-2:]
        return upsample_bilinear_matmul(logits_s4, 4 * H4, 4 * W4), hidden, logits_s16


class PropagationNetwork(nn.Module):
    """The submodules in one place.  Published widths: key 64, value 128, sensory
    64, decoder 128 / 64."""

    def __init__(self, value_dim: int = VALUE_DIM, in_dim: int = 128, dec_dim: int = 64,
                 stage3_n: int = 1, with_pyramid_adapter: bool = False,
                 pyramid_channels: Tuple[int, int, int] = (128, 256, 512)):
        super().__init__()
        self.value_dim = value_dim
        self.key_encoder = KeyEncoder(stage3_n)
        self.value_encoder = ValueEncoder(value_dim)
        self.sensory = SensoryUpdater(in_dim)
        self.decoder = MaskDecoder(value_dim, in_dim, dec_dim)
        if with_pyramid_adapter:
            self.pyr_adapter = PyramidAdapter(tuple(pyramid_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded random init: LeCun-normal kernels, zero biases, BatchNorm at identity."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                with torch.no_grad():
                    m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
                m.reset_running_stats()

    def encode_key(self, image):
        return self.key_encoder(image)

    def encode_from_pyramid(self, p3, p4, p5, out_hw, content_box=None):
        """Detector pyramid → (key (B, Ck, h16, w16), skips)."""
        skips = self.pyr_adapter(p3, p4, p5, out_hw, content_box)
        return self.key_encoder.project_key(skips["f16"]), skips

    def encode_value(self, f16, mask_s16, sensory):
        return self.value_encoder(f16, mask_s16, sensory)

    def update_sensory(self, hidden, feat):
        return self.sensory(hidden, feat)

    def decode(self, readout, skips, sensory, full_res: bool = True):
        return self.decoder(readout, skips, sensory, full_res)

    def project_skips(self, skips):
        return self.decoder.project_skips(skips)

    def decode_head(self, readout, sensory):
        return self.decoder.head(readout, sensory)

    def decode_tail(self, hidden, f8p, f4p):
        return self.decoder.decode_tail(hidden, f8p, f4p)


def memory_readout(query_key, mem_keys, mem_values, mem_valid, top_k: int = 30):
    """Affinity softmax over the ``top_k`` best memory elements per query, then
    the value gather (the XMem-faithful numerics reference).  query_key (Q, Ck);
    mem_keys (M, Ck); mem_values (No, M, Cv); mem_valid (M,) bool → (No, Q, Cv)."""
    scale = query_key.shape[-1] ** -0.5
    aff = torch.matmul(query_key, mem_keys.T) * scale
    aff = torch.where(mem_valid[None, :], aff, aff.new_tensor(-1e9))
    topv, topi = torch.topk(aff, min(top_k, aff.shape[-1]), dim=-1)            # (Q, k)
    w = torch.softmax(topv, dim=-1)
    return torch.einsum("qk,nqkc->nqc", w, mem_values[:, topi])


def memory_readout_dense(query_key, mem_keys, mem_values, mem_valid, return_usage: bool = False,
                         affinity_bf16: bool = False):
    """Dense full-softmax readout in plain PyTorch: affinity (Q, M) → masked
    softmax → (Q, M) @ (No, M, Cv).  ``return_usage=True`` also returns the
    attention mass per memory element (M,), the long-term consolidation signal.
    ``affinity_bf16=True`` rounds the affinity to bf16; the softmax statistics
    stay fp32."""
    scale = query_key.shape[-1] ** -0.5
    aff = torch.matmul(query_key.float(), mem_keys.float().T)
    if affinity_bf16:
        aff = (aff.to(torch.bfloat16) * torch.tensor(scale, dtype=torch.bfloat16)).float()
    else:
        aff = aff * scale
    valid = mem_valid[None, :]
    aff = aff.masked_fill(~valid, float("-inf"))
    m = aff.max(dim=-1, keepdim=True).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))     # all-invalid rows → zero readout
    p = (torch.exp(aff - m) * valid).to(mem_values.dtype)
    denom = p.float().sum(dim=-1, keepdim=True).clamp_min(1e-9)      # (Q, 1)
    out = (torch.matmul(p.float(), mem_values.float()) / denom[None]).to(mem_values.dtype)
    if return_usage:
        return out, (p.float() * (1.0 / denom)).sum(dim=0)
    return out


def memory_readout_dense_int8(query_key, keys_i8, k_scale, values_i8, v_scale, slot_valid,
                              out_dtype=torch.float32, return_usage: bool = False):
    """Dense readout of an int8 ring (``init_memory(quantized=True)``): both
    products s8×s8→s32.  The JAX package computes them with ``jnp.einsum``, not
    with a Pallas kernel, and so does the port with PyTorch calls
    (``nn/quant.py int_mm``, ``torch._int_mm`` on the card); the readout kernel
    has no int8 path and does not run here.

    query_key (Q, Ck) fp, quantised per call with one scale; keys_i8 (T, HW, Ck)
    and k_scale (T,); values_i8 (No, T, HW, Cv) and v_scale (No, T); slot_valid
    (T,) bool → (No, Q, Cv) in ``out_dtype``, and with ``return_usage`` the
    attention mass per ring element (T, HW).  The affinity is dequantised per
    slot, invalid slots are −inf, and the softmax max is taken per query over all
    (t, h); its weights are quantised per query (``rowmax / 127``, clipped to
    [0, 127]) and their sum is the denominator.  A per-slot value scale varies
    along the contracted axis, so the value product runs once per slot, the
    objects folded into the columns and HW zero-padded to a multiple of 8 (exact),
    and each slot is dequantised before the sum over slots."""
    T, HW, Ck = keys_i8.shape
    No, _, _, Cv = values_i8.shape
    Q = query_key.shape[0]
    sq = absmax_scale(query_key)
    qi8 = quantize(query_key, sq)
    aff = int_mm(qi8, keys_i8.reshape(T * HW, Ck)).float().view(Q, T, HW)
    aff = aff * (sq * Ck ** -0.5) * k_scale[None, :, None]             # dequantised per slot
    valid = slot_valid[None, :, None]
    aff = aff.masked_fill(~valid, float("-inf"))
    m = aff.amax(dim=(1, 2), keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(aff - m) * valid                                       # (Q, T, HW) fp32
    sp = p.amax(dim=(1, 2), keepdim=True).clamp_min(1e-9) * RCP127       # p in (0, 1]: rowmax / 127
    pi8 = quantize(p, sp, lo=0)
    pq = pi8.float() * sp                                                # the dequantised weights
    l = pq.sum(dim=(1, 2)).clamp_min(1e-9)                               # (Q,)
    vals = values_i8.permute(1, 0, 3, 2).reshape(T, No * Cv, HW)        # (T, No·Cv, HW)
    out = torch.stack([int_mm(pi8[:, t].contiguous(), vals[t]) for t in range(T)])   # (T, Q, No·Cv) int32
    out = (out.float().view(T, Q, No, Cv) * v_scale.T[:, None, :, None]).sum(0)      # per-slot dequant, T-sum
    out = (out.permute(1, 0, 2) * (sp.reshape(1, Q, 1) / l[None, :, None])).to(out_dtype)
    if return_usage:
        return out, torch.einsum("qth,q->th", pq, 1.0 / l)
    return out


def decode_tail_subpix(decoder: MaskDecoder, hidden, f8p, f4p, dtype=torch.float32):
    """The packed decode tail in plain PyTorch (the JAX package's
    ``decode_tail_subpix``), channels last: hidden (N, No, H16, W16, Cin), f8p
    (N, H8, W8, Cd), f4p (N, H4, W4, Cd) → stride-4 logits (N, No, H4, W4) fp32."""
    from yolo_puncture_tpu_torch.ops.kernels.decode_tail import decode_tail_reference

    return decode_tail_reference(decoder.tail_params(dtype), hidden.to(dtype), f8p.to(dtype), f4p)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: min(max(x, lo), hi), whose gradient splits evenly where x
    equals a bound (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def soft_aggregate(logits, active, eps: float = 1e-7):
    """Per-object sigmoid logits (…, No, H, W) → normalised probabilities
    (…, No+1, H, W), background = Π(1 − pᵢ)."""
    p = torch.sigmoid(logits) * active[:, None, None]
    bg = clip(torch.prod(1.0 - p, dim=-3, keepdim=True), eps, 1.0)
    stack = torch.cat([torch.log(bg / (1 - bg + eps) + eps), torch.log(p / (1 - p + eps) + eps)], -3)
    return torch.softmax(stack, dim=-3)
