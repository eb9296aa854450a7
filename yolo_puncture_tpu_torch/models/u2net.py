"""U²-Net and U2NETP, the salient-object segmenter that refines the app's needle masks (NCHW).

Counterpart of ``yolo_puncture_tpu/models/u2net.py``: REBNCONV (3×3 conv with
dilation, BatchNorm, ReLU), the residual U-blocks RSU7..RSU4 and the fully
dilated RSU4F, a six-level encoder and five-level decoder, six side outputs
fused by a 1×1 conv; ``forward`` returns the seven sigmoid maps, the fused one
first.  U2NETP (``small=True``) has every middle width 16 and every block
width 64.

The modules carry the reference's torch names (``stage1.rebnconvin.conv_s1``,
``side1``, ``outconv``, …), so its raw state dict loads with
``load_state_dict``, and ``utils/convert.py export_u2net_state_dict`` turns the
JAX package's variables into that state dict.

Down-sampling is ``max_pool2d(2, 2, ceil_mode=True)``; up-sampling is
``jax.image.resize``'s bilinear (``ops/resize.py resize_bilinear``) at the
ratios the odd sizes give (380 → 190 → 95 → 48 → 24 → 12 and back).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolo_puncture_tpu_torch.ops.resize import resize_bilinear


def _maxpool2_ceil(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _upsample_like(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of ``src`` to ``tgt``'s spatial size, as ``jax.image.resize``."""
    hw = tuple(tgt.shape[2:])
    if tuple(src.shape[2:]) == hw:
        return src
    return resize_bilinear(src.permute(0, 2, 3, 1), hw).permute(0, 3, 1, 2)


class REBNCONV(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate, dilation=dirate)
        self.bn_s1 = nn.BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn_s1(self.conv_s1(x)))


class RSU(nn.Module):
    """Residual U-block with ``height`` levels (RSU7 → height 7 … RSU4 → height 4)."""

    def __init__(self, height: int, in_ch: int, mid: int, out: int):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(in_ch, out)
        for i in range(1, height):
            self.add_module(f"rebnconv{i}", REBNCONV(out if i == 1 else mid, mid))
        self.add_module(f"rebnconv{height}", REBNCONV(mid, mid, 2))
        for i in range(height - 1, 0, -1):
            self.add_module(f"rebnconv{i}d", REBNCONV(2 * mid, mid if i > 1 else out))

    def forward(self, x):
        L = self.height
        hxin = self.rebnconvin(x)
        enc, h = [], hxin
        for i in range(1, L):
            h = getattr(self, f"rebnconv{i}")(h)
            enc.append(h)
            if i < L - 1:
                h = _maxpool2_ceil(h)
        h = getattr(self, f"rebnconv{L}")(h)
        for i in range(L - 1, 0, -1):
            h = getattr(self, f"rebnconv{i}d")(torch.cat([h, enc[i - 1]], 1))
            if i > 1:
                h = _upsample_like(h, enc[i - 2])
        return h + hxin


class RSU4F(nn.Module):
    """Fully dilated RSU: no pooling, dilations 1, 2, 4, 8."""

    def __init__(self, in_ch: int, mid: int, out: int):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out)
        self.rebnconv1 = REBNCONV(out, mid, 1)
        self.rebnconv2 = REBNCONV(mid, mid, 2)
        self.rebnconv3 = REBNCONV(mid, mid, 4)
        self.rebnconv4 = REBNCONV(mid, mid, 8)
        self.rebnconv3d = REBNCONV(2 * mid, mid, 4)
        self.rebnconv2d = REBNCONV(2 * mid, mid, 2)
        self.rebnconv1d = REBNCONV(2 * mid, out, 1)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        h3d = self.rebnconv3d(torch.cat([h4, h3], 1))
        h2d = self.rebnconv2d(torch.cat([h3d, h2], 1))
        return self.rebnconv1d(torch.cat([h2d, h1], 1)) + hxin


# (kind, height, in, mid, out) of stage1..6, stage5d..1d: the reference's U2NET and U2NETP
_FULL = [("rsu", 7, 3, 32, 64), ("rsu", 6, 64, 32, 128), ("rsu", 5, 128, 64, 256), ("rsu", 4, 256, 128, 512),
         ("f", 0, 512, 256, 512), ("f", 0, 512, 256, 512), ("f", 0, 1024, 256, 512), ("rsu", 4, 1024, 128, 256),
         ("rsu", 5, 512, 64, 128), ("rsu", 6, 256, 32, 64), ("rsu", 7, 128, 16, 64)]
_SMALL = [("rsu", 7, 3, 16, 64), ("rsu", 6, 64, 16, 64), ("rsu", 5, 64, 16, 64), ("rsu", 4, 64, 16, 64),
          ("f", 0, 64, 16, 64), ("f", 0, 64, 16, 64), ("f", 0, 128, 16, 64), ("rsu", 4, 128, 16, 64),
          ("rsu", 5, 128, 16, 64), ("rsu", 6, 128, 16, 64), ("rsu", 7, 128, 16, 64)]
_STAGES = ["stage1", "stage2", "stage3", "stage4", "stage5", "stage6", "stage5d", "stage4d", "stage3d", "stage2d",
           "stage1d"]


class U2Net(nn.Module):
    """Full U²-Net or, with ``small``, U2NETP.  ``forward`` takes NCHW images
    and returns the seven sigmoid maps (B, out_ch, H, W), the fused one first."""

    def __init__(self, out_ch: int = 1, small: bool = False):
        super().__init__()
        spec = _SMALL if small else _FULL
        for name, (kind, height, cin, mid, out) in zip(_STAGES, spec):
            self.add_module(name, RSU(height, cin, mid, out) if kind == "rsu" else RSU4F(cin, mid, out))
        side_ch = [64] * 6 if small else [64, 64, 128, 256, 512, 512]
        for i, c in enumerate(side_ch, 1):
            self.add_module(f"side{i}", nn.Conv2d(c, out_ch, 3, padding=1))
        self.outconv = nn.Conv2d(6 * out_ch, out_ch, 1)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "U2Net":
        """Seeded random init: LeCun-normal kernels, zero biases, identity
        BatchNorm statistics."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / math.sqrt(m.weight[0].numel()))
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        return self

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        hx1 = self.stage1(x)
        hx2 = self.stage2(_maxpool2_ceil(hx1))
        hx3 = self.stage3(_maxpool2_ceil(hx2))
        hx4 = self.stage4(_maxpool2_ceil(hx3))
        hx5 = self.stage5(_maxpool2_ceil(hx4))
        hx6 = self.stage6(_maxpool2_ceil(hx5))
        hx5d = self.stage5d(torch.cat([_upsample_like(hx6, hx5), hx5], 1))
        hx4d = self.stage4d(torch.cat([_upsample_like(hx5d, hx4), hx4], 1))
        hx3d = self.stage3d(torch.cat([_upsample_like(hx4d, hx3), hx3], 1))
        hx2d = self.stage2d(torch.cat([_upsample_like(hx3d, hx2), hx2], 1))
        hx1d = self.stage1d(torch.cat([_upsample_like(hx2d, hx1), hx1], 1))
        d1 = self.side1(hx1d)
        sides = [d1] + [_upsample_like(getattr(self, f"side{i}")(h), x)
                        for i, h in zip(range(2, 7), (hx2d, hx3d, hx4d, hx5d, hx6))]
        d0 = self.outconv(torch.cat(sides, 1))
        return tuple(torch.sigmoid(d) for d in [d0] + sides)


def norm_pred(d: torch.Tensor) -> torch.Tensor:
    """Min-max normalisation over the whole tensor (the reference's ``normPRED``)."""
    ma, mi = d.max(), d.min()
    return (d - mi) / (ma - mi)
