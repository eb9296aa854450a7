"""Visual Attention Network (VAN) b0–b6, the second insertion classifier family (NCHW).

Counterpart of ``yolo_puncture_tpu/models/van.py``.  Module names are the
published VAN code's (Visual-Attention-Network ``models/van.py``), so a VAN
checkpoint loads by key: ``patch_embed{s}.proj|norm``, ``block{s}.{i}.norm1``,
``attn.proj_1``, ``attn.spatial_gating_unit.conv0|conv_spatial|conv1``,
``attn.proj_2``, ``norm2``, ``mlp.fc1``, ``mlp.dwconv.dwconv`` (the published
``DWConv`` wraps its convolution one level down, where the JAX module names it
``mlp/dwconv``), ``mlp.fc2``, ``layer_scale_1|2``, then ``norm{s}`` and ``head``.
``utils/convert.py export_classifier_state_dict`` carries the JAX package's
variables across.

As in the JAX package: BatchNorm eps 1e-5 with flax's momentum 0.9 (torch's
0.1), flax's BatchNorm in ``train()`` (``nn/common.py BatchNorm2d``); the stage
LayerNorm over channels with flax's eps 1e-6; exact GELU; the 7×7 depthwise
convolution dilated 3 with padding 9; MLP ratios (8, 8, 4, 4) for every variant;
the head a mean over H and W, then ``Linear``.  VAN has no dropout: ``forward``
takes the fine-tuner's ``dropout_generator`` and ignores it.

A model built with ``dtype=torch.bfloat16`` computes as the JAX package's
``dtype=bfloat16`` does: convolutions and the head in bf16; BatchNorm and
LayerNorm keep fp32 parameters, normalise in fp32 and round their output to
bf16; the layer scales stay fp32, so each ``x + ls * y`` carries the residual
stream in fp32 from the first block on, as flax's type promotion does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from yolo_puncture_tpu_torch.nn.common import BatchNorm2d, torch_batch_statistics
from yolo_puncture_tpu_torch.registry import register_model

# variant: (widths, depths)
_CFG = {
    "b0": ((32, 64, 160, 256), (3, 3, 5, 2)),
    "b1": ((64, 128, 320, 512), (2, 2, 4, 2)),
    "b2": ((64, 128, 320, 512), (3, 3, 12, 3)),
    "b3": ((64, 128, 320, 512), (3, 5, 27, 3)),
    "b4": ((64, 128, 320, 512), (3, 6, 40, 3)),
    "b5": ((96, 192, 480, 768), (3, 3, 24, 3)),
    "b6": ((96, 192, 384, 768), (6, 6, 90, 6)),
}
MLP_RATIOS = (8, 8, 4, 4)
BN_EPS = 1e-5
BN_MOMENTUM = 0.1           # flax's momentum 0.9: running ← 0.9 · running + 0.1 · batch
LN_EPS = 1e-6               # flax's LayerNorm default


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def _wide(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


class LKA(nn.Module):
    """Large-kernel attention: 5×5 depthwise, 7×7 depthwise dilated 3, 1×1; ``u * attn``."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv0 = nn.Conv2d(dim, dim, 5, padding=2, groups=dim)
        self.conv_spatial = nn.Conv2d(dim, dim, 7, padding=9, groups=dim, dilation=3)
        self.conv1 = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        return x * self.conv1(self.conv_spatial(self.conv0(x)))


class VanAttention(nn.Module):
    """proj_1 → GELU → LKA → proj_2, plus the input."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj_1 = nn.Conv2d(dim, dim, 1)
        self.spatial_gating_unit = LKA(dim)
        self.proj_2 = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        return self.proj_2(self.spatial_gating_unit(F.gelu(self.proj_1(x)))) + x


class DWConv(nn.Module):
    """The published ``DWConv``: a 3×3 depthwise convolution under the name ``dwconv``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x):
        return self.dwconv(x)


class VanMlp(nn.Module):
    """fc1 (1×1) → 3×3 depthwise → GELU → fc2 (1×1)."""

    def __init__(self, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Conv2d(out, hidden, 1)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Conv2d(hidden, out, 1)

    def forward(self, x):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x))))


class VanBlock(nn.Module):
    """BatchNorm, attention, layer-scaled residual; BatchNorm, MLP, layer-scaled residual."""

    def __init__(self, dim: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = _bn(dim)
        self.attn = VanAttention(dim)
        self.norm2 = _bn(dim)
        self.mlp = VanMlp(dim * mlp_ratio, dim)
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), 1e-2))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), 1e-2))

    def forward(self, x):
        dtype = self.attn.proj_1.weight.dtype
        x = x + self.layer_scale_1[:, None, None] * self.attn(self.norm1(x).to(dtype))
        return x + self.layer_scale_2[:, None, None] * self.mlp(self.norm2(x).to(dtype))


class OverlapPatchEmbed(nn.Module):
    """A strided convolution that overlaps its patches, then BatchNorm."""

    def __init__(self, cin: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, stride, padding=patch // 2)
        self.norm = _bn(dim)

    def forward(self, x):
        return self.norm(self.proj(x)).to(self.proj.weight.dtype)


class VAN(nn.Module):
    """VAN-``variant`` with a ``num_classes`` linear head, NCHW input (timm's
    layout), logits out.  In ``eval()`` BatchNorm runs on its running statistics;
    in ``train()`` on the batch's (flax's update of the running statistics)."""

    def __init__(self, variant: str = "b0", num_classes: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        dims, depths = _CFG[variant]
        cin = 3
        for s in range(4):
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbed(cin, dims[s], 7 if s == 0 else 3,
                                                                   4 if s == 0 else 2))
            setattr(self, f"block{s + 1}", nn.ModuleList(VanBlock(dims[s], MLP_RATIOS[s])
                                                         for _ in range(depths[s])))
            setattr(self, f"norm{s + 1}", nn.LayerNorm(dims[s], eps=LN_EPS))
            cin = dims[s]
        self.head = nn.Linear(dims[3], num_classes)
        self._cast(dtype)
        self.eval()

    def _cast(self, dtype: torch.dtype) -> None:
        """Convolutions and the head in ``dtype``; BatchNorm, LayerNorm and the
        layer scales stay fp32, as flax keeps its parameters."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "VAN":
        """Seeded random init: LeCun-normal conv and linear weights, zero biases,
        layer scales 1e-2 (the JAX init), and BatchNorm running statistics from one
        train-mode forward of seeded noise, so that the logits of a random model
        differ from frame to frame.  The init runs in fp32 whatever ``dtype`` is,
        so that a bf16 model holds the fp32 model's weights rounded."""
        self._cast(torch.float32)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                w.copy_(torch.randn(w.shape, generator=generator) * math.sqrt(1.0 / w[0].numel()))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, VanBlock):
                m.layer_scale_1.fill_(1e-2)
                m.layer_scale_2.fill_(1e-2)
        bns = [m for m in self.modules() if isinstance(m, nn.BatchNorm2d)]
        for m in bns:
            m.reset_parameters()
            m.momentum = 1.0  # running statistics := this batch's statistics
        images = torch.rand((4, self.patch_embed1.proj.in_channels, 96, 96), generator=generator)
        dtype, self.dtype = self.dtype, torch.float32
        self.train()
        with torch_batch_statistics(self):
            self(images.to(self.head.weight.device))
        self.eval()
        self.dtype = dtype
        for m in bns:
            m.momentum = BN_MOMENTUM
        self._cast(dtype)
        return self

    def forward(self, x: torch.Tensor, dropout_generator: torch.Generator = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for s in range(1, 5):
            x = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                x = blk(x)
            norm = getattr(self, f"norm{s}")
            # over channels, statistics in fp32 (or wider), the output rounded to the compute type
            y = F.layer_norm(x.permute(0, 2, 3, 1).to(_wide(x)), norm.normalized_shape, norm.weight.to(_wide(x)),
                             norm.bias.to(_wide(x)), norm.eps)
            x = y.to(self.dtype).permute(0, 3, 1, 2)
        return self.head(x.mean(dim=(2, 3), dtype=_wide(x)).to(self.dtype))


for _v in _CFG:
    def _ctor(num_classes=2, dtype=torch.float32, _v=_v, **kw):
        return VAN(variant=_v, num_classes=num_classes, dtype=dtype)

    register_model(_ctor, name=f"van_{_v}")
