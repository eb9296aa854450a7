"""Fused tracker decode tail: hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``yolo_puncture_tpu/ops/pallas/decode_tail.py`` (``_kernel`` /
``decode_tail_pallas``).  Per (frame, object) cell it computes the mask
decoder's tail — 2× nearest upsample → 3×3 conv ``dec8`` → BN → SiLU → ``+ f8p``
→ 2× upsample → 3×3 conv ``dec4`` → BN → SiLU → ``+ f4p`` → 1×1 ``out`` head —
in the subpixel-packed form: each conv runs at the LOW resolution with the
weights of ``subpix_up_weights`` (four parity groups of output channels,
un-packed by depth-to-space), the head is applied per parity group, and the
linear ``f4p`` term is a per-frame skip plane ``f4p · w_out + bias`` added at the
end.  The stride-4 64-channel per-object tensor is never written to device memory.

Layouts are the JAX package's, channels last: hidden (N, No, H16, W16, Cin),
f8p (N, H8, W8, Cd), f4p (N, H4, W4, Cd) → logits (N, No, H4, W4) fp32.
Activations are fp32 or bf16; accumulation is fp32; in bf16 the weights are
rounded to bf16 first and the activations where the TPU kernel rounds them
(after the first SiLU, before the head).

The packed weights, the BN affines and the head's weights are prepared once per
set of weights by ``pack_decode_tail_params`` and handed to every call.  The
kernel lives in ``csrc/decode_tail.cu``; its header states the bound and the
design: two stages, each an implicit GEMM per parity group on the tensor cores
(``wgmma``), the zero taps of each group skipped, the activations fed from
registers out of a halo patch that one TMA load brings, bf16 as stored and fp32
as three error-compensated TF32 products.  The weights reach the kernel as
finished shared-memory images, ``wgmma_weight_tiles``: per (parity group, chunk
of 128 bytes of input channels, live tap, plane) one K-major 64 × 128-byte tile
with the 128-byte swizzle applied, for fp32 a ``hi`` and a ``lo`` plane
(``split_tf32``), made here once per set of weights so that no call prepares
anything.  On a CPU tensor the wrapper runs ``decode_tail_reference``; on a
CUDA tensor it launches the kernel or raises.

Gradients (training): the packed parameters keep the decoder's raw tensors
(``DecodeTailParams.raw``: the ``dec8`` / ``dec4`` conv weights, their BatchNorm
affine and running statistics, the head's weight and bias).  Where grad mode is
on and the activations or a raw weight require a gradient, the call goes through
``DecodeTail``, an ``autograd.Function`` whose forward is the kernel (or the plain
version) on the packed parameters and whose backward is the vector-Jacobian
product of the un-packed tail (``decode_tail_unpacked``: nearest up-sample →
3×3 conv → BN affine → SiLU → skip, twice, then the 1×1 head), recomputed in the
backward: the function JAX's autodiff differentiates, so the raw weights get
their gradients with no algebra on the packed form.  Running statistics are
buffers and get none.  In bf16 (bf16 training) the forward is the kernel's bf16
route and the backward the vector-Jacobian product of the packed tail in bf16
(``decode_tail_packed_bf16``), the function of JAX's ``decode_tail_subpix(...,
dtype=bfloat16)``: packed weights rounded to bf16, bf16 convolutions, the BN
affine and SiLU in fp32 rounded after the SiLU, the head in bf16, the skip plane
in fp32 past its bf16 product.  The raw weights' gradients come back through the
casts, so a bf16 weight gets a bf16 gradient and an fp32 one (the BN affine) an
fp32 gradient.  Other types raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import torch
import torch.nn.functional as F

from yolo_puncture_tpu_torch import _build
from yolo_puncture_tpu_torch.nn.common import BN_EPS

KERNEL_IN_DIM, KERNEL_DEC_DIM = 128, 64  # the widths the kernel is compiled for


def subpix_up_weights(K: torch.Tensor) -> torch.Tensor:
    """3×3 kernel (3, 3, Cin, Cout) → (3, 3, Cin, 4·Cout): the one-conv form of
    [nearest-neighbour 2× upsample → 3×3 stride-1 conv, pad 1].

    Output parity (di, dj) of the upsampled conv only sees a 2×2 neighbourhood
    of the low-resolution input (each 3×3 tap lands on a repeated pixel), so it
    collapses to a 2×2 kernel with summed taps: output row 2i+di reads up-rows
    2i+di+u−1, u ∈ {0, 1, 2}, and up-row p is low-row p//2, so di = 0 hits rows
    {i−1, i, i} and di = 1 hits {i, i, i+1}.  The four parities pack into one
    3×3-support conv with 4·Cout channels, group g = 2·di + dj on support rows
    {di, di+1} and columns {dj, dj+1}."""
    rows = (torch.stack([K[0], K[1] + K[2]]), torch.stack([K[0] + K[1], K[2]]))

    def cols(r):
        return (torch.stack([r[:, 0], r[:, 1] + r[:, 2]], dim=1),
                torch.stack([r[:, 0] + r[:, 1], r[:, 2]], dim=1))

    Cin, Cout = K.shape[2], K.shape[3]
    W = K.new_zeros((3, 3, Cin, 4 * Cout))
    for di, r in enumerate(rows):
        for dj, w2 in enumerate(cols(r)):
            g = (di * 2 + dj) * Cout
            W[di:di + 2, dj:dj + 2, :, g:g + Cout] = w2
    return W


def depth_to_space2(y: torch.Tensor, Cout: int) -> torch.Tensor:
    """(..., H, W, 4·Cout) parity-grouped, channels last → (..., 2H, 2W, Cout)."""
    *lead, H, W, _ = y.shape
    n = len(lead)
    y = y.reshape(*lead, H, W, 2, 2, Cout)
    return y.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4).reshape(*lead, 2 * H, 2 * W, Cout)


@lru_cache(maxsize=None)
def subpix_tap_map(device) -> torch.Tensor:
    """(3, 3, 4, 9) of 0 and 1: ``subpix_up_weights`` as one linear map, packed
    tap (r, c) of parity group g summing the 3×3 kernel's taps t = 3a + b that
    carry a 1 (the map applied to each basis kernel), so that packing under
    autograd is one product and its transpose another."""
    basis = torch.eye(9).reshape(9, 3, 3, 1, 1)
    return torch.stack([subpix_up_weights(k)[..., 0, :] for k in basis], dim=-1).to(device)


def packed_kernel(w: torch.Tensor) -> torch.Tensor:
    """OIHW 3×3 kernel (Cout, Cin, 3, 3) → the packed kernel (3, 3, Cin, 4·Cout)
    of ``subpix_up_weights``, in one product with ``subpix_tap_map``."""
    Cout, Cin = w.shape[:2]
    out = torch.einsum("rcgt,oit->rcigo", subpix_tap_map(w.device).to(w.dtype), w.reshape(Cout, Cin, 9))
    return out.reshape(3, 3, Cin, 4 * Cout)


@dataclasses.dataclass(frozen=True)
class DecodeTailParams:
    """What the tail needs of the decoder's weights, prepared once: all fp32 and
    contiguous on one device (in bf16 mode already rounded to bf16 values)."""

    w8: torch.Tensor     # (3, 3, Cin, 4·Cd) packed dec8 kernel
    a8: torch.Tensor     # (2, 4·Cd) BN scale row and bias row, tiled over the parity groups
    w4: torch.Tensor     # (3, 3, Cd, 4·Cd) packed dec4 kernel
    a4: torch.Tensor     # (2, 4·Cd)
    w_out: torch.Tensor  # (Cd,) the 1×1 head
    b_out: torch.Tensor  # (1,) its bias
    dtype: torch.dtype   # the activation type these were rounded for
    t8: torch.Tensor     # ``wgmma_weight_tiles(w8, dtype)``: what the kernel multiplies by
    t4: torch.Tensor     # ``wgmma_weight_tiles(w4, dtype)``; both None at widths the kernel is not compiled for
    raw: tuple = ()      # the raw tensors, ``RAW_FIELDS`` in order, not copies: the backward differentiates them


RAW_FIELDS = ("dec8.conv.weight", "dec8.bn.weight", "dec8.bn.bias", "dec8.bn.running_mean", "dec8.bn.running_var",
              "dec4.conv.weight", "dec4.bn.weight", "dec4.bn.bias", "dec4.bn.running_mean", "dec4.bn.running_var",
              "out.weight", "out.bias")


TILE_ROW_BYTES = 128  # a weight tile's row: one chunk of input channels, 32 fp32 or 64 bf16


def split_tf32(x: torch.Tensor):
    """fp32 → (hi, lo): hi is x rounded to TF32 (10 explicit mantissa bits, ties
    away from zero, done on the bits as the kernel does), lo = x − hi, exact in
    fp32, so hi + lo == x."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, x - hi


def live_taps(W: torch.Tensor) -> torch.Tensor:
    """Packed kernel (3, 3, Cin, 4·Cd) → (4 groups, 4 taps, Cin, Cd): tap
    t = 2a + b of parity group g = 2·di + dj is packed row di + a, column dj + b,
    channels g·Cd … g·Cd + Cd − 1.  The other five taps of a group are zero."""
    Cd = W.shape[3] // 4
    return torch.stack([
        torch.stack([W[(g >> 1) + (t >> 1), (g & 1) + (t & 1), :, g * Cd:(g + 1) * Cd] for t in range(4)])
        for g in range(4)
    ])


def tile_k_order(dtype: torch.dtype) -> torch.Tensor:
    """Which input channel of a chunk sits in k slot k′ of a weight tile's row.
    A thread (quad lane c) loads 32 contiguous bytes of an activation row, and
    they must be its ``wgmma`` A fragments of the chunk's four k-steps as they
    stand.  TF32 (k-step s of 8 slots, a thread holds slots c and c + 4):
    slot j of step s is channel 8·(j % 4) + 2·s + j // 4.  bf16 (k-step of 16
    slots, a thread holds 2c, 2c + 1, 2c + 8, 2c + 9): slot j of step s is
    channel 16·((j % 8) // 2) + 4·s + 2·(j // 8) + j % 2."""
    if dtype == torch.float32:
        s, j = torch.arange(4)[:, None], torch.arange(8)[None, :]
        return (8 * (j % 4) + 2 * s + j // 4).reshape(-1)
    s, j = torch.arange(4)[:, None], torch.arange(16)[None, :]
    return (16 * ((j % 8) // 2) + 4 * s + 2 * (j // 8) + j % 2).reshape(-1)


def tile_n_order() -> torch.Tensor:
    """Which output channel sits in row n of a weight tile: a thread (quad lane
    c) holds accumulator columns 8j + 2c + e, and row n = 8j + 2c + e is channel
    16c + 2j + e, so that the thread owns 16 neighbouring channels of a pixel."""
    n = torch.arange(64)
    return 16 * ((n % 8) // 2) + 2 * (n // 8) + n % 2


def _swizzle_128(tiles: torch.Tensor) -> torch.Tensor:
    """(..., 64 rows, row elements): the 16-byte piece p of row n moves to piece
    p ^ (n % 8), the 128-byte swizzle of TMA and ``wgmma``.  Its own inverse."""
    *lead, rows, width = tiles.shape
    per = width // 8
    pieces = tiles.reshape(*lead, rows, 8, per)
    src = torch.arange(8)[None, :] ^ (torch.arange(rows)[:, None] % 8)          # (rows, 8)
    idx = src.reshape(*([1] * len(lead)), rows, 8, 1).expand(*lead, rows, 8, per)
    return torch.gather(pieces, -2, idx.to(tiles.device)).reshape(*lead, rows, width)


def wgmma_weight_tiles(W: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Packed kernel (3, 3, Cin, 4·64) fp32 → the kernel's B operand,
    (4 groups, Cin / KC chunks, 4 taps, planes, 64, KC) of ``dtype``: KC = 32 and
    planes (hi, lo) of ``split_tf32`` for fp32, KC = 64 and one plane for bf16;
    rows in ``tile_n_order``, k slots in ``tile_k_order``, swizzled."""
    if W.shape[3] != 4 * KERNEL_DEC_DIM:
        raise ValueError(f"weight tiles are made for {KERNEL_DEC_DIM} output channels a group")
    kc = TILE_ROW_BYTES // torch.empty((), dtype=dtype).element_size()
    Cin = W.shape[2]
    if dtype not in (torch.float32, torch.bfloat16) or Cin % kc:
        raise ValueError(f"weight tiles need fp32 or bf16 and Cin a multiple of {kc}, got {dtype}, {Cin}")
    t = live_taps(W.float()).reshape(4, 4, Cin // kc, kc, KERNEL_DEC_DIM)
    t = t[:, :, :, tile_k_order(dtype).to(W.device)][..., tile_n_order().to(W.device)]  # (g, tap, chunk, k′, n)
    t = t.permute(0, 2, 1, 4, 3)                                                           # (g, chunk, tap, n, k′)
    planes = torch.stack(split_tf32(t.contiguous()), dim=3) if dtype == torch.float32 else t.to(dtype)[:, :, :, None]
    return _swizzle_128(planes).contiguous()


def _bn_affine(bn: torch.nn.BatchNorm2d) -> torch.Tensor:
    g = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    b = bn.bias.float() - bn.running_mean.float() * g
    return torch.stack([g.repeat(4), b.repeat(4)]).contiguous()


@torch.no_grad()
def pack_decode_tail_params(dec8, dec4, out, dtype: torch.dtype = torch.float32) -> DecodeTailParams:
    """dec8, dec4: the decoder's ``ConvBN`` blocks (OIHW conv weights, BatchNorm
    on its running statistics); out: its 1×1 ``Conv2d`` head.  ``dtype`` is the
    activation type the tail will run in."""
    if dec8.bn.eps != BN_EPS or dec4.bn.eps != BN_EPS:
        raise ValueError("the decode tail folds BatchNorm with eps 1e-3")

    def rounded(t):
        return t.detach().float().to(dtype).float().contiguous().clone()

    w8 = rounded(subpix_up_weights(dec8.conv.weight.float().permute(2, 3, 1, 0)))
    w4 = rounded(subpix_up_weights(dec4.conv.weight.float().permute(2, 3, 1, 0)))
    kernel_widths = (w8.shape[2], w4.shape[2]) == (KERNEL_IN_DIM, KERNEL_DEC_DIM) and dtype in (
        torch.float32, torch.bfloat16)
    return DecodeTailParams(
        w8=w8,
        a8=_bn_affine(dec8.bn),
        w4=w4,
        a4=_bn_affine(dec4.bn),
        w_out=rounded(out.weight[0, :, 0, 0]),
        b_out=out.bias.detach().float().reshape(1).clone(),
        dtype=dtype,
        t8=wgmma_weight_tiles(w8, dtype) if kernel_widths else None,
        t4=wgmma_weight_tiles(w4, dtype) if kernel_widths else None,
        raw=tuple(t for c in (dec8, dec4) for t in (c.conv.weight, c.bn.weight, c.bn.bias, c.bn.running_mean,
                                                   c.bn.running_var)) + (out.weight, out.bias),
    )


def skip_plane(params: DecodeTailParams, f4p: torch.Tensor) -> torch.Tensor:
    """(N, H4, W4) fp32: the head applied to the object-free skip, f4p · w_out + bias."""
    return (torch.einsum("nhwc,c->nhw", f4p.float(), params.w_out) + params.b_out).contiguous()


def decode_tail_reference(params: DecodeTailParams, hidden, f8p, f4p) -> torch.Tensor:
    """Plain PyTorch version: the packed algebra with ``F.conv2d``."""
    dtype = params.dtype
    N, No, H16, W16, Cin = hidden.shape
    Cd = params.w_out.shape[0]

    def rnd(x):
        return x if dtype == torch.float32 else x.to(dtype).float()

    def stage(x, w, a):
        """x (B, H, W, Cin) → SiLU(BN(packed conv)) (B, H, W, 4·Cd), fp32."""
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
        return F.silu(y * a[0] + a[1])

    x = rnd(hidden.float()).reshape(N * No, H16, W16, Cin)
    y8 = depth_to_space2(rnd(stage(x, params.w8, params.a8)), Cd)            # (N·No, H8, W8, Cd)
    y8 = rnd(y8.reshape(N, No, 2 * H16, 2 * W16, Cd) + rnd(f8p.float())[:, None])
    y4 = rnd(stage(y8.reshape(N * No, 2 * H16, 2 * W16, Cd), params.w4, params.a4))
    o = torch.einsum("bhwgc,c->bhwg", y4.reshape(*y4.shape[:-1], 4, Cd), params.w_out)
    o = depth_to_space2(o, 1).reshape(N, No, 4 * H16, 4 * W16)
    return o + skip_plane(params, f4p)[:, None]


def decode_tail_unpacked(raw, hidden, f8p, f4p) -> torch.Tensor:
    """The un-packed tail on the raw tensors (``RAW_FIELDS``), channels last
    (the wrapper's layouts) → stride-4 logits (N, No, H4, W4): what the JAX
    package's ``MaskDecoder.decode_tail`` computes, and what ``DecodeTail``
    differentiates."""
    w8, g8, b8, m8, v8, w4, g4, b4, m4, v4, w_out, b_out = raw
    N, No, H16, W16, Cin = hidden.shape

    def stage(x, w, g, b, m, v):
        """nearest 2× → 3×3 conv → BN on its running statistics → SiLU, NCHW."""
        y = F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), w, padding=1)
        a = g * torch.rsqrt(v + BN_EPS)
        return F.silu(y * a[:, None, None] + (b - m * a)[:, None, None])

    x = hidden.reshape(N * No, H16, W16, Cin).permute(0, 3, 1, 2)
    y8 = stage(x, w8, g8, b8, m8, v8)
    y8 = (y8.reshape(N, No, *y8.shape[1:]) + f8p.permute(0, 3, 1, 2)[:, None]).flatten(0, 1)
    y4 = stage(y8, w4, g4, b4, m4, v4)
    y4 = y4.reshape(N, No, *y4.shape[1:]) + f4p.permute(0, 3, 1, 2)[:, None]
    return F.conv2d(y4.flatten(0, 1), w_out, b_out).reshape(N, No, 4 * H16, 4 * W16)


def decode_tail_packed_bf16(raw, hidden, f8p, f4p) -> torch.Tensor:
    """The packed tail in bf16 on the raw tensors, channels last → stride-4 logits
    (N, No, H4, W4) fp32: what the JAX package's ``decode_tail_subpix(...,
    dtype=bfloat16)`` computes, and what ``DecodeTail`` differentiates in bf16.
    Each 3×3 convolution takes the packed kernel (``packed_kernel`` in fp32)
    rounded to bf16 and gives bf16; the BN affine ``scale / √(var + eps)``,
    ``bias − mean · scale`` and SiLU follow in fp32, rounded to bf16 after the
    SiLU, as the kernel applies them (and as XLA fuses the JAX function's bf16
    affine and SiLU on the CPU), so that the BatchNorm parameters' gradients are
    fp32 sums, as flax's BatchNorm gives them; the head's weights are rounded to
    bf16 for the per-parity product and the skip product, and its bias is added
    to the skip plane in fp32."""
    w8, g8, b8, m8, v8, w4, g4, b4, m4, v4, w_out, b_out = raw
    bf16 = torch.bfloat16
    N, No, H16, W16, Cin = hidden.shape
    Cd = w_out.shape[1]

    def stage(x, w, g, b, m, v):
        """x (B, H, W, C) bf16 → SiLU(BN(packed conv)) (B, H, W, 4, Cd) bf16."""
        packed = packed_kernel(w.float()).to(bf16)
        y = F.conv2d(x.permute(0, 3, 1, 2), packed.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
        a = g.float() / torch.sqrt(v.float() + BN_EPS)
        return F.silu(y.reshape(*y.shape[:-1], 4, Cd).float() * a + (b.float() - m.float() * a)).to(bf16)

    y = stage(hidden.reshape(N * No, H16, W16, Cin).to(bf16), w8, g8, b8, m8, v8)
    y = depth_to_space2(y.reshape(N * No, H16, W16, 4 * Cd), Cd)
    y = y.reshape(N, No, 2 * H16, 2 * W16, Cd) + f8p[:, None].to(bf16)
    y = stage(y.reshape(N * No, 2 * H16, 2 * W16, Cd), w4, g4, b4, m4, v4)
    wo = w_out[0, :, 0, 0].to(bf16)
    o = depth_to_space2(torch.einsum("bhwgc,c->bhwg", y, wo), 1).reshape(N, No, 4 * H16, 4 * W16)
    skip = torch.einsum("bhwc,c->bhw", f4p.to(bf16), wo).float() + b_out[0].float()
    return o.float() + skip[:, None]


class DecodeTail(torch.autograd.Function):
    """The tail with its gradient: forward the kernel on CUDA tensors (the plain
    version on CPU tensors) on the packed parameters, backward the
    vector-Jacobian product of ``decode_tail_unpacked`` (fp32) or
    ``decode_tail_packed_bf16`` (bf16) on the raw tensors."""

    @staticmethod
    def forward(ctx, params, hidden, f8p, f4p, *raw):
        ctx.save_for_backward(hidden, f8p, f4p, *raw)
        ctx.tail = decode_tail_unpacked if params.dtype == torch.float32 else decode_tail_packed_bf16
        return _tail_forward(params, hidden, f8p, f4p)

    @staticmethod
    def backward(ctx, d_out):
        saved = ctx.saved_tensors
        wanted = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(w) for t, w in zip(saved, wanted)]
            out = ctx.tail(inputs[3:], *inputs[:3])
            diff = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, diff, d_out) if diff else ())
        return (None, *(next(grads) if w else None for w in wanted))


@lru_cache(maxsize=None)
def kernel_fn():
    """The C entry point ``decode_tail`` (built on first use), argtypes set."""
    fn = _build.load("decode_tail").decode_tail
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_args(params: DecodeTailParams, hidden, f8p, oskip, y8, out):
    """Arguments of ``kernel_fn()`` for checked tensors, on the current stream."""
    N, No, H16, W16, Cin = hidden.shape
    return (
        hidden.data_ptr(), f8p.data_ptr(), oskip.data_ptr(), params.t8.data_ptr(), params.a8.data_ptr(),
        params.t4.data_ptr(), params.a4.data_ptr(), params.w_out.data_ptr(), y8.data_ptr(), out.data_ptr(),
        N, No, H16, W16, Cin, params.w_out.shape[0], int(hidden.dtype == torch.bfloat16),
        torch.cuda.current_stream(hidden.device).cuda_stream,
    )


def _check(params, hidden, f8p, f4p):
    if hidden.dim() != 5 or f8p.dim() != 4 or f4p.dim() != 4:
        raise ValueError("decode_tail wants hidden (N, No, H16, W16, Cin), f8p (N, H8, W8, Cd), f4p (N, H4, W4, Cd)")
    N, No, H16, W16, Cin = hidden.shape
    Cd = params.w_out.shape[0]
    if (tuple(f8p.shape) != (N, 2 * H16, 2 * W16, Cd) or tuple(f4p.shape) != (N, 4 * H16, 4 * W16, Cd)
            or tuple(params.w8.shape) != (3, 3, Cin, 4 * Cd)):
        raise ValueError(
            f"shape mismatch: hidden {tuple(hidden.shape)}, f8p {tuple(f8p.shape)}, f4p {tuple(f4p.shape)}, "
            f"packed dec8 weights {tuple(params.w8.shape)}"
        )
    for name, t in (("f8p", f8p), ("f4p", f4p), ("weights", params.w8)):
        if t.device != hidden.device:
            raise ValueError(f"{name} is on {t.device}, hidden on {hidden.device}")
    if hidden.dtype != params.dtype or f8p.dtype != params.dtype:
        raise TypeError(
            f"decode_tail: weights were prepared for {params.dtype}, hidden is {hidden.dtype}, f8p {f8p.dtype}"
        )


def decode_tail(params: DecodeTailParams, hidden, f8p, f4p) -> torch.Tensor:
    """hidden (N, No, H16, W16, Cin), f8p (N, H8, W8, Cd), f4p (N, H4, W4, Cd),
    channels last → stride-4 logits (N, No, H4, W4) fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel (fp32 or
    bf16 activations of the type ``params`` was prepared for, contiguous,
    Cin == 128, Cd == 64) and anything else raises.  Where grad mode is on and
    the activations or a raw weight require a gradient, the same forward runs
    inside ``DecodeTail``, which gives the gradients (fp32 or bf16; another type
    raises)."""
    _check(params, hidden, f8p, f4p)
    if hidden.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_tail runs on cpu or cuda, not {hidden.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (hidden, f8p, f4p, *params.raw)):
        if params.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"decode_tail's gradient takes fp32 or bf16 activations, got {params.dtype}")
        if len(params.raw) != len(RAW_FIELDS):
            raise ValueError("decode_tail's gradient needs the raw tensors: prepare params with pack_decode_tail_params")
        return DecodeTail.apply(params, hidden, f8p, f4p, *params.raw)
    return _tail_forward(params, hidden, f8p, f4p)


def _tail_forward(params: DecodeTailParams, hidden, f8p, f4p) -> torch.Tensor:
    if hidden.device.type == "cpu":
        return decode_tail_reference(params, hidden, f8p, f4p)
    if hidden.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_tail kernel takes fp32 or bf16 activations, got {hidden.dtype}")
    for name, t in (("hidden", hidden), ("f8p", f8p)):
        if not t.is_contiguous():
            raise ValueError(f"decode_tail kernel takes contiguous {name}")
    N, No, H16, W16, Cin = hidden.shape
    Cd = params.w_out.shape[0]
    if Cin != KERNEL_IN_DIM or Cd != KERNEL_DEC_DIM:
        raise ValueError(
            f"decode_tail kernel is compiled for Cin == {KERNEL_IN_DIM}, Cd == {KERNEL_DEC_DIM}, got {Cin}, {Cd}"
        )
    for name, t in (("hidden", hidden), ("f8p", f8p)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_tail kernel takes a 16-byte aligned {name}")
    out = torch.empty((N, No, 4 * H16, 4 * W16), dtype=torch.float32, device=hidden.device)
    if out.numel() == 0:
        return out
    oskip = skip_plane(params, f4p)
    y8 = torch.empty((N * No, 2 * H16, 2 * W16, Cd), dtype=hidden.dtype, device=hidden.device)  # stage-1 output
    with torch.cuda.device(hidden.device):
        rc = kernel_fn()(*kernel_args(params, hidden, f8p, oskip, y8, out))
    if rc != 0:
        raise RuntimeError(f"decode_tail kernel launch failed: {_build.error_string('decode_tail', rc)}")
    decode_tail.launches += 1
    return out


decode_tail.launches = 0  # wrapper calls that launched the kernel's two stages, since the last reset
