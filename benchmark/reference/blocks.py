"""Convolution and attention blocks of YOLOv10 in plain fp32 PyTorch (NCHW).

Names follow the ultralytics state-dict layout (``cv1.conv.weight``,
``m.0.cv2.bn.running_var`` …).  Padding is ``k // 2``; BatchNorm has eps 1e-3
and, in ``eval()``, runs on its running statistics.  Each product goes through
the module's ``num`` (``numerics.py``), fp32 unless ``set_numerics`` says fp8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.numerics import FP32, Numerics

BN_EPS = 1e-3


def set_numerics(module: nn.Module, num: Numerics) -> nn.Module:
    for m in module.modules():
        m.num = num
    return module


class Block(nn.Module):
    num: Numerics = FP32


class ConvBN(Block):
    """Conv2d without bias, BatchNorm, SiLU (ultralytics ``Conv``)."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2 if p is None else p, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS)
        self.act = act

    def forward(self, x):
        c = self.conv
        x = self.bn(self.num.conv(x, c.weight, None, c.stride, c.padding, c.groups))
        return F.silu(x) if self.act else x


def conv1x1(num: Numerics, conv: nn.Conv2d, x):
    """A plain ``nn.Conv2d`` (with bias) through ``num``."""
    return num.conv(x, conv.weight, conv.bias, conv.stride, conv.padding, conv.groups)


class Bottleneck(Block):
    def __init__(self, c1, c2, shortcut=True, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 3)
        self.cv2 = ConvBN(c_, c2, 3)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(Block):
    def __init__(self, c1, c2, n=1, shortcut=False, e=0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1)
        self.cv2 = ConvBN((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, e=1.0) for _ in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class RepVGGDW(Block):
    def __init__(self, ed):
        super().__init__()
        self.conv = ConvBN(ed, ed, 7, 1, 3, g=ed, act=False)
        self.conv1 = ConvBN(ed, ed, 3, 1, 1, g=ed, act=False)

    def forward(self, x):
        return F.silu(self.conv(x) + self.conv1(x) + x)


class CIB(Block):
    def __init__(self, c1, c2, shortcut=True, e=0.5, lk=False):
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
    def __init__(self, c1, c2, n=1, shortcut=False, lk=False, e=0.5):
        super().__init__(c1, c2, n, shortcut, e)
        self.m = nn.ModuleList(CIB(self.c, self.c, shortcut, e=1.0, lk=lk) for _ in range(n))


class SPPF(Block):
    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN(c_ * 4, c2, 1)
        self.k = k

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(ys, 1))


class SCDown(Block):
    def __init__(self, c1, c2, k=3, s=2):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 1)
        self.cv2 = ConvBN(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class Attention(Block):
    """softmax(qᵀk · key_dim^-0.5) over the H·W positions, plus a depthwise
    positional convolution of v."""

    def __init__(self, dim, num_heads=8, attn_ratio=0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        self.qkv = ConvBN(dim, dim + 2 * self.key_dim * num_heads, 1, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)
        self.pe = ConvBN(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        qkv = self.qkv(x).view(B, self.num_heads, 2 * self.key_dim + self.head_dim, H * W)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = (self.num.matmul(q.transpose(-2, -1), k) * self.scale).softmax(dim=-1)
        out = self.num.matmul(v, attn.transpose(-2, -1)).reshape(B, C, H, W)
        return self.proj(out + self.pe(v.reshape(B, C, H, W)))


class PSA(Block):
    def __init__(self, c1, c2, e=0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1)
        self.cv2 = ConvBN(2 * self.c, c2, 1)
        self.attn = Attention(self.c, max(1, self.c // 64), 0.5)
        self.ffn = nn.Sequential(ConvBN(self.c, self.c * 2, 1), ConvBN(self.c * 2, self.c, 1, act=False))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat((a, b), 1))


class Proto(Block):
    """Mask prototypes: 3×3 conv, 2× transposed-conv upsample, 3×3 conv, 1×1 conv."""

    def __init__(self, c1, c_=256, c2=32):
        super().__init__()
        self.cv1 = ConvBN(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = ConvBN(c_, c_, 3)
        self.cv3 = ConvBN(c_, c2)

    def forward(self, x):
        up = self.upsample
        return self.cv3(self.cv2(self.num.conv_transpose(self.cv1(x), up.weight, up.bias, 2)))
