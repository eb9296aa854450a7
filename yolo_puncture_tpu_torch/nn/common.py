"""Convolutional and attention blocks of the YOLO v8/v10/v11 family (NCHW).

Counterpart of ``yolo_puncture_tpu/nn/common.py``.  Module and attribute names
follow the ultralytics state-dict layout (``cv1.conv.weight``, ``m.0.cv2.bn``,
``cv1.2.conv1.conv`` …), so checkpoints and the weight bridge load by name.
Padding is the explicit symmetric ``k // 2`` (``autopad``); BatchNorm uses
ultralytics' eps 1e-3.  In ``eval()`` BatchNorm runs on its running statistics;
in ``train()`` it is flax's ``BatchNorm`` (``BatchNorm2d``): the batch's biased
variance, and the running statistics moved towards it.

A bf16 model (``to_compute_dtype``) is the JAX package's ``dtype=bfloat16``:
convolutions and linear layers compute in bf16 on bf16 weights (flax keeps fp32
parameters and rounds them to bf16 at each use, which gives the same values),
and BatchNorm keeps fp32 statistics and affine parameters, normalises a bf16
input in fp32 and rounds its output to bf16 (flax ``BatchNorm(dtype=bf16)``).

Training such a model keeps flax's fp32 parameters too: a parameter rounded to
bf16 remembers the fp32 value it was rounded from (``fp32_value``), and the
trainers hold ``MasterWeights``: fp32 masters that the optimizer updates, copied
(rounded) into the bf16 module after each update, and the bf16 gradients of the
module's parameters widened into the masters' fp32 gradients, which is what the
vector-Jacobian product of flax's cast gives.  Serving keeps its bf16 weights
and pays no cast per forward.

``ConvBN`` runs its convolution through ``nn/quant.py conv_forward``: inside
``int8_convs`` it is an int8 product, inside ``collect_act_scales`` its input's
scale is recorded, elsewhere it is the plain convolution.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolo_puncture_tpu_torch.nn import quant

BN_EPS = 1e-3
_GLOBAL_BATCH = threading.local()


@contextlib.contextmanager
def global_batch(batch_sum: Callable[[torch.Tensor], torch.Tensor], shards: int):
    """Inside the block this thread's batch-wide reductions span a global batch
    of ``shards`` equal shards, one a process: ``BatchNorm2d``'s training sums and
    ``train/losses.py``'s normalisers go through ``batch_sum``, a sum over the
    shards whose backward sums the gradient too.  ``parallel/mesh.py``'s
    ``with mesh:`` installs the all-reduce over ``data``."""
    prev = global_batch_hook()
    _GLOBAL_BATCH.hook = (batch_sum, shards)
    try:
        yield
    finally:
        _GLOBAL_BATCH.hook = prev


def global_batch_hook() -> Optional[Tuple[Callable[[torch.Tensor], torch.Tensor], int]]:
    """``(batch_sum, shards)`` of the innermost ``global_batch``, or None in one process."""
    return getattr(_GLOBAL_BATCH, "hook", None)


def to_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every parameter outside BatchNorm to ``dtype``; BatchNorm layers keep
    fp32 statistics and affine parameters, and PyTorch's BatchNorm then computes
    in fp32 on an input of another type and returns that type.  ``model.to(dtype)``
    would round the statistics too.  The cast is ``cast_parameters``: a rounded
    parameter keeps its fp32 value, and a cast back to fp32 restores it."""
    for m in module.modules():
        if not isinstance(m, nn.modules.batchnorm._BatchNorm):
            cast_parameters(m, dtype)
    return module


def _keep_fp32(p: torch.Tensor, value: Optional[torch.Tensor]) -> None:
    """Record (or, with None, forget) the fp32 value a rounded parameter stands
    for.  With ``fp32_value`` the only code that reads or writes that record."""
    if value is None:
        p.__dict__.pop("_kept_fp32", None)
    else:
        p._kept_fp32 = value


def fp32_value(p: torch.Tensor, required: bool = False) -> torch.Tensor:
    """The fp32 value of a parameter: itself if it is fp32; for a parameter that
    ``cast_parameters`` rounded, the fp32 value it was rounded from (moved to its
    device).  A parameter with no such value (made or loaded in a narrow type)
    is widened, which is exact, unless ``required``: then it raises, as it does
    when the kept value no longer rounds to the parameter (its weights were
    written after the cast by a path that kept no fp32 value)."""
    if p.dtype == torch.float32:
        return p.detach()
    kept = p.__dict__.get("_kept_fp32")
    if kept is None:
        if required:
            raise ValueError(f"a {p.dtype} parameter of shape {tuple(p.shape)} has no fp32 value: build or load "
                             f"the model in fp32 and cast it (to_compute_dtype), or load fp32 weights into it")
        return p.detach().float()
    kept = kept.detach().to(p.device)
    if kept.shape != p.shape or not torch.equal(kept.to(p.dtype), p.detach()):
        raise ValueError(f"a {p.dtype} parameter of shape {tuple(p.shape)} was written after it was rounded, and "
                         f"its kept fp32 value no longer rounds to it")
    return kept


def fp32_state_dict(module: nn.Module) -> dict:
    """``module.state_dict()`` with each parameter at its fp32 value
    (``fp32_value``): the weights a checkpoint or a flax variable tree holds,
    fp32 as the JAX package keeps them under a bf16 ``dtype``."""
    params = dict(module.named_parameters())
    return {k: fp32_value(params[k]) if k in params else v for k, v in module.state_dict().items()}


def _keep_fp32_on_load(module, state_dict, prefix, *_):
    """``load_state_dict`` pre-hook of a module whose parameters were rounded: an
    fp32 (or wider) tensor loaded into such a parameter is kept as its fp32 value;
    a narrower one leaves it none."""
    for name, p in module.named_parameters(recurse=False):
        v = state_dict.get(prefix + name)
        if p.dtype != torch.float32 and isinstance(v, torch.Tensor) and v.shape == p.shape:
            wide = v.dtype in (torch.float32, torch.float64)
            _keep_fp32(p, v.detach().to("cpu", torch.float32, copy=True) if wide else None)


def cast_parameters(module: nn.Module, dtype: torch.dtype) -> None:
    """Cast ``module``'s own parameters (not its children's) to ``dtype``.  An fp32
    parameter rounded to a narrower type keeps its fp32 value on the host
    (``fp32_value``; 4 bytes a weight of host memory, serving models included),
    and so does one into which ``load_state_dict`` later loads fp32 weights; a
    rounded parameter cast back to fp32 gets that value again."""
    params = list(module.parameters(recurse=False))
    for p in params:
        if p.dtype == dtype:
            continue
        if dtype == torch.float32:
            p.data = fp32_value(p).clone()
            _keep_fp32(p, None)
        else:
            if p.dtype == torch.float32:
                _keep_fp32(p, p.detach().to("cpu", copy=True))
            p.data = p.data.to(dtype)
    if dtype != torch.float32 and params and not getattr(module, "_keeps_fp32_on_load", False):
        module.register_load_state_dict_pre_hook(_keep_fp32_on_load)
        module._keeps_fp32_on_load = True


class MasterWeights:
    """fp32 master weights of a module's trainable parameters: flax's fp32
    parameters under a bf16 ``dtype``.  An fp32 (or float64) parameter is its own
    master; a bf16 one gets an fp32 master made from its kept fp32 value
    (``fp32_value``, which raises where there is none), and from then on the
    master is that value.  The optimizer updates the masters;
    ``copy_to_module`` rounds them into the module (one ``torch._foreach_copy_``,
    which also moves the version counters that caches of packed weights key on);
    ``collect_grads`` adds the module's gradients, widened to fp32, to the
    masters' and clears them."""

    def __init__(self, module: nn.Module):
        self.named = {}
        self.pairs = []
        for name, p in module.named_parameters():
            if not p.requires_grad:
                continue
            master = p
            if p.dtype.itemsize < 4:
                master = nn.Parameter(fp32_value(p, required=True).clone())
                _keep_fp32(p, master)
                self.pairs.append((p, master))
            self.named[name] = master

    @property
    def masters(self):
        return list(self.named.values())

    @torch.no_grad()
    def copy_to_module(self) -> None:
        if self.pairs:
            torch._foreach_copy_([p for p, _ in self.pairs], [m for _, m in self.pairs])

    def collect_grads(self) -> None:
        for p, m in self.pairs:
            if p.grad is not None:
                g = p.grad.float()
                m.grad = g if m.grad is None else m.grad.add_(g)
                p.grad = None


def autopad(k: int, p: Optional[int] = None, d: int = 1) -> int:
    """'same'-shape padding for odd kernels, torch Conv2d(p=k//2)."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training forward is flax's ``BatchNorm(use_running_average=False)``:
    statistics over (N, H, W) in fp32 (or wider), the variance E[x²] − E[x]² floored at 0
    (biased, flax's fast variance), and ``running ← (1 − momentum)·running +
    momentum·batch`` with that biased variance (torch's own update takes the
    unbiased one); momentum 0.03 is flax's 0.97.  Inside ``global_batch``
    (a data-parallel step) the statistics are the global batch's: the sums of x
    and x² go through its differentiable sum over the shards (SyncBatchNorm's
    semantics), so the running statistics stay the same on every rank.  ``eval()`` is unchanged, and so is a layer inside
    ``torch_batch_statistics``."""

    flax_statistics = True

    def forward(self, x):
        if not (self.training and self.flax_statistics):
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        hook = global_batch_hook()
        if hook is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf * xf).mean(dim=(0, 2, 3)) - mean * mean
        else:
            batch_sum, shards = hook
            sums = batch_sum(torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))]))
            moments = sums / (xf.numel() // xf.shape[1] * shards)
            mean, var = moments[0], moments[1] - moments[0] * moments[0]
        var = torch.maximum(var, var.new_zeros(()))
        if self.track_running_stats:
            keep = 1.0 - self.momentum
            with torch.no_grad():
                self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
                self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
                self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]).to(x.dtype)


@contextlib.contextmanager
def torch_batch_statistics(module: nn.Module):
    """Inside the block the ``BatchNorm2d`` layers of ``module`` train as
    ``torch.nn.BatchNorm2d`` does (the unbiased variance in the running
    statistics).  The seeded inits measure their statistics so, as they did
    before the layers followed flax in training, so that a seed gives the
    weights it gave then."""
    layers = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in layers:
        m.flax_statistics = False
    try:
        yield module
    finally:
        for m in layers:
            m.flax_statistics = True


class ConvBN(nn.Module):
    """Conv2d(bias=False) + BatchNorm + SiLU: ultralytics ``Conv``."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, d: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, dilation=d, bias=False)
        self.conv.flax_path = "conv"          # the JAX module path; YOLOModel sets its own
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=0.03)
        self.act = act

    def forward(self, x):
        x = self.bn(quant.conv_forward(self.conv, x))
        return F.silu(x) if self.act else x


class DWConv(ConvBN):
    """Depthwise conv (groups == channels)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, act: bool = True):
        super().__init__(c1, c2, k, s, g=c1, act=act)


class Bottleneck(nn.Module):
    """cv1 → cv2, plus the input when ``shortcut`` and the widths match."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: Tuple[int, int] = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, k[0], 1)
        self.cv2 = ConvBN(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with two convolutions and n inner bottlenecks (dense splits)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBN((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(
            Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n)
        )

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class C3(nn.Module):
    """CSP bottleneck with three convolutions."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k: Tuple[int, int] = (1, 3)):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c1, c_, 1, 1)
        self.cv3 = ConvBN(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, k=k, e=1.0) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class C3k(C3):
    """C3 with a configurable bottleneck kernel (YOLO11)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k: int = 3):
        super().__init__(c1, c2, n, shortcut, g, e, k=(k, k))


class C3k2(C2f):
    """YOLO11 block: C2f whose inner modules are C3k (when c3k) or Bottleneck."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.m = nn.ModuleList(
            C3k(self.c, self.c, 2, shortcut, g) if c3k else Bottleneck(self.c, self.c, shortcut, g)
            for _ in range(n)
        )


def max_pool_same(x, k: int, stride: int = 1):
    """MaxPool2d(k, stride, padding=k//2) on NCHW."""
    return F.max_pool2d(x, k, stride, k // 2)


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three stacked k=5 max pools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(max_pool_same(ys[-1], self.k))
        return self.cv2(torch.cat(ys, 1))


class SCDown(nn.Module):
    """YOLOv10 spatial-channel decoupled downsample: 1×1 pointwise + k×k depthwise."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 1, 1)
        self.cv2 = ConvBN(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class RepVGGDW(nn.Module):
    """7×7 depthwise + 3×3 depthwise + identity, SiLU after the sum."""

    def __init__(self, ed: int):
        super().__init__()
        self.conv = ConvBN(ed, ed, 7, 1, 3, g=ed, act=False)
        self.conv1 = ConvBN(ed, ed, 3, 1, 1, g=ed, act=False)

    def forward(self, x):
        return F.silu(self.conv(x) + self.conv1(x) + x)


class CIB(nn.Module):
    """YOLOv10 compact inverted block (dw–pw–dw–pw–dw, optional residual)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(
            ConvBN(c1, c1, 3, g=c1),
            ConvBN(c1, 2 * c_, 1),
            RepVGGDW(2 * c_) if lk else ConvBN(2 * c_, 2 * c_, 3, g=2 * c_),
            ConvBN(2 * c_, c2, 1),
            ConvBN(c2, c2, 3, g=c2),
        )
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C2f):
    """C2f with CIB inner blocks (YOLOv10)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, lk: bool = False,
                 g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.m = nn.ModuleList(CIB(self.c, self.c, shortcut, e=1.0, lk=lk) for _ in range(n))


class Attention(nn.Module):
    """Partial self-attention core (ultralytics ``Attention``): softmax(q·kᵀ·scale)·v
    over the H·W positions, plus a depthwise positional conv of v.  Plain
    matmuls and an fp32 softmax, as the JAX package leaves them to XLA."""

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        h = dim + 2 * self.key_dim * num_heads
        self.qkv = ConvBN(dim, h, 1, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)
        self.pe = ConvBN(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        N = H * W
        qkv = self.qkv(x).view(B, self.num_heads, 2 * self.key_dim + self.head_dim, N)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = torch.matmul(q.transpose(-2, -1), k) * self.scale  # (B, h, N, N)
        attn = attn.float().softmax(dim=-1).to(v.dtype)
        out = torch.matmul(v, attn.transpose(-2, -1)).reshape(B, C, H, W)
        return self.proj(out + self.pe(v.reshape(B, C, H, W)))


class PSABlock(nn.Module):
    """Attention + FFN residual block (C2PSA's inner block)."""

    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int = 4, shortcut: bool = True):
        super().__init__()
        self.attn = Attention(c, num_heads, attn_ratio)
        self.ffn = nn.Sequential(ConvBN(c, c * 2, 1), ConvBN(c * 2, c, 1, act=False))
        self.add = shortcut

    def forward(self, x):
        x = x + self.attn(x) if self.add else self.attn(x)
        return x + self.ffn(x) if self.add else self.ffn(x)


class PSA(nn.Module):
    """YOLOv10 partial self-attention: split channels, attend half, re-fuse."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBN(2 * self.c, c2, 1)
        self.attn = Attention(self.c, max(1, self.c // 64), 0.5)
        self.ffn = nn.Sequential(ConvBN(self.c, self.c * 2, 1), ConvBN(self.c * 2, self.c, 1, act=False))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat((a, b), 1))


class C2PSA(nn.Module):
    """YOLO11: stacked PSABlocks inside a C2-style split."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBN(2 * self.c, c2, 1)
        self.m = nn.Sequential(
            *(PSABlock(self.c, 0.5, max(1, self.c // 64)) for _ in range(n))
        )

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        return self.cv2(torch.cat((a, self.m(b)), 1))


class Proto(nn.Module):
    """Segmentation prototypes: conv → 2× ConvTranspose upsample → conv → 1×1."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = ConvBN(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = ConvBN(c_, c_, 3)
        self.cv3 = ConvBN(c_, c2)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


def upsample_nearest_2x(x):
    """Nearest-neighbour 2× upsample of NCHW (torch nn.Upsample(scale_factor=2))."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def dfl_expectation(box_dist, reg_max: int = 16):
    """Distribution Focal Loss decode: (..., 4·reg_max) → (..., 4), fp32 softmax
    over the bins, then the expected bin."""
    d = box_dist.reshape(*box_dist.shape[:-1], 4, reg_max).float()
    bins = torch.arange(reg_max, dtype=torch.float32, device=d.device)
    return (d.softmax(dim=-1) * bins).sum(dim=-1)
