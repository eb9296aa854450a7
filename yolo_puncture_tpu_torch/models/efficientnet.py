"""EfficientNet B0–B7 (MBConv with squeeze-excite), the insertion-state classifier.

Counterpart of ``yolo_puncture_tpu/models/efficientnet.py``.  The reference's
classifier is timm ``efficientnet_b3`` with two classes on 380² crops.  Module
names follow timm (``conv_stem``, ``bn1``, ``blocks.{s}.{i}.conv_pw|conv_dw|
se.conv_reduce|se.conv_expand|conv_pwl|bn1..3``, ``conv_head``, ``bn2``,
``classifier``), so a timm checkpoint loads by key, and
``utils/convert.py export_classifier_state_dict`` carries the JAX package's
variables across.  As there: BatchNorm eps 1e-3, symmetric ``k // 2`` padding
(also at stride 2), and a squeeze-excite width of a quarter of the block's input.

In ``train()`` BatchNorm is flax's (``nn/common.py BatchNorm2d``) with the JAX
package's momentum 0.99, and the head applies the variant's dropout.

``EfficientNet.forward`` takes NCHW images (timm's layout) and returns logits;
``preprocess_classifier`` turns RGB uint8 NHWC crops into that input.  A model
built with ``dtype=torch.bfloat16`` computes as the JAX package's
``dtype=bfloat16`` does (``nn/common.py to_compute_dtype``: bf16 convolutions
and head, fp32 BatchNorm statistics with bf16 output).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from yolo_puncture_tpu_torch.nn.common import BatchNorm2d, to_compute_dtype, torch_batch_statistics
from yolo_puncture_tpu_torch.ops.masks import _linear_weight_mat
from yolo_puncture_tpu_torch.registry import register_model

# (expand_ratio, kernel, stride, channels, repeats)
_BASE_BLOCKS = [
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
]

# width_mult, depth_mult, resolution, dropout
_CFG = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-3
BN_MOMENTUM = 0.01          # flax's momentum 0.99: running ← 0.99 · running + 0.01 · batch


def round_filters(c: int, width_mult: float, divisor: int = 8) -> int:
    c *= width_mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def round_repeats(n: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * n))


def _conv(cin: int, cout: int, k: int, s: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, s, padding=k // 2, groups=groups, bias=False)


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, reduced: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(c, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, c, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class DepthwiseSeparable(nn.Module):
    """timm ``DepthwiseSeparableConv`` (stage 0, no expansion): depthwise conv,
    squeeze-excite, pointwise conv; the residual only at stride 1 with equal widths."""

    def __init__(self, cin: int, cout: int, k: int, s: int):
        super().__init__()
        self.conv_dw = _conv(cin, cin, k, s, groups=cin)
        self.bn1 = _bn(cin)
        self.se = SqueezeExcite(cin, max(1, int(cin * 0.25)))
        self.conv_pw = _conv(cin, cout, 1)
        self.bn2 = _bn(cout)
        self.residual = s == 1 and cin == cout

    def forward(self, x):
        y = self.se(F.silu(self.bn1(self.conv_dw(x))))
        y = self.bn2(self.conv_pw(y))
        return x + y if self.residual else y


class InvertedResidual(nn.Module):
    """timm ``InvertedResidual`` (MBConv): expand, depthwise, squeeze-excite, project."""

    def __init__(self, cin: int, cout: int, k: int, s: int, expand_ratio: int):
        super().__init__()
        mid = cin * expand_ratio
        self.conv_pw = _conv(cin, mid, 1)
        self.bn1 = _bn(mid)
        self.conv_dw = _conv(mid, mid, k, s, groups=mid)
        self.bn2 = _bn(mid)
        self.se = SqueezeExcite(mid, max(1, int(cin * 0.25)))
        self.conv_pwl = _conv(mid, cout, 1)
        self.bn3 = _bn(cout)
        self.residual = s == 1 and cin == cout

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_pw(x)))
        y = F.silu(self.bn2(self.conv_dw(y)))
        y = self.bn3(self.conv_pwl(self.se(y)))
        return x + y if self.residual else y


class EfficientNet(nn.Module):
    """EfficientNet-``variant`` with a ``num_classes`` linear head.  In ``eval()``
    BatchNorm runs on its running statistics and there is no dropout; in
    ``train()`` the pooled features go through dropout at the variant's rate
    (``drop_rate``), its mask drawn from ``forward``'s ``dropout_generator``."""

    def __init__(self, variant: str = "b3", num_classes: int = 2, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        width, depth, _, self.drop_rate = _CFG[variant]
        stem = round_filters(32, width)
        self.conv_stem = _conv(in_chans, stem, 3, 2)
        self.bn1 = _bn(stem)
        stages, cin = [], stem
        for e, k, st, c, n in _BASE_BLOCKS:
            cout = round_filters(c, width)
            blocks = []
            for i in range(round_repeats(n, depth)):
                stride = st if i == 0 else 1
                blocks.append(DepthwiseSeparable(cin, cout, k, stride) if e == 1
                              else InvertedResidual(cin, cout, k, stride, e))
                cin = cout
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        head = round_filters(1280, width)
        self.conv_head = _conv(cin, head, 1)
        self.bn2 = _bn(head)
        self.classifier = nn.Linear(head, num_classes)
        to_compute_dtype(self, dtype)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "EfficientNet":
        """Seeded random init: LeCun-normal conv and linear weights, zero biases,
        and BatchNorm running statistics from one train-mode forward of seeded
        noise, so that every layer of a random model stays near unit scale and
        its two logits differ from frame to frame.  The init runs in fp32 whatever
        ``dtype`` is, so that a bf16 model holds the fp32 model's weights rounded."""
        to_compute_dtype(self, torch.float32)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                w.copy_(torch.randn(w.shape, generator=generator) * math.sqrt(1.0 / w[0].numel()))
                if m.bias is not None:
                    m.bias.zero_()
        bns = [m for m in self.modules() if isinstance(m, nn.BatchNorm2d)]
        for m in bns:
            m.reset_parameters()
            m.momentum = 1.0  # running statistics := this batch's statistics
        images = torch.rand((4, self.conv_stem.in_channels, 96, 96), generator=generator)
        self.train()
        with torch_batch_statistics(self):
            self._forward(images.to(self.classifier.weight.device))
        self.eval()
        for m in bns:
            m.momentum = BN_MOMENTUM
        to_compute_dtype(self, self.dtype)
        return self

    def forward(self, x: torch.Tensor, dropout_generator: torch.Generator = None) -> torch.Tensor:
        return self._forward(x.to(self.dtype), dropout_generator)

    def _forward(self, x: torch.Tensor, dropout_generator: torch.Generator = None) -> torch.Tensor:
        y = F.silu(self.bn1(self.conv_stem(x)))
        y = self.blocks(y)
        y = F.silu(self.bn2(self.conv_head(y))).mean(dim=(2, 3))
        if self.training and self.drop_rate > 0:     # flax's Dropout: keep with 1 − rate, scale the kept
            keep = torch.rand(y.shape, generator=dropout_generator, device=y.device) >= self.drop_rate
            y = torch.where(keep, y / (1.0 - self.drop_rate), torch.zeros_like(y))
        return self.classifier(y)


def preprocess_classifier(images_u8: torch.Tensor, size: int = 380,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """RGB uint8 (B, H, W, 3) → ImageNet-normalised (B, 3, size, size), computed
    in fp32 and cast to ``dtype`` at the end, as the JAX package does.

    A crop that is not size² is resized with the JAX package's
    ``jax.image.resize(method="bilinear")``, which is the antialiased
    ``scale_and_translate`` (a triangle widened by the shrink factor), not
    ``F.interpolate``."""
    x = images_u8.to(torch.float32) / 255.0
    B, H, W, _ = x.shape
    if (H, W) != (size, size):
        wh = _linear_weight_mat(H, size, size / H, 0.0, x.device)
        ww = _linear_weight_mat(W, size, size / W, 0.0, x.device)
        x = torch.einsum("bhwc,hH->bHwc", x, wh)
        x = torch.einsum("bHwc,wW->bHWc", x, ww)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype).permute(0, 3, 1, 2).contiguous()


for _v in _CFG:
    def _ctor(num_classes=2, in_chans=3, dtype=torch.float32, _v=_v, **kw):
        return EfficientNet(variant=_v, num_classes=num_classes, in_chans=in_chans, dtype=dtype)

    register_model(_ctor, name=f"efficientnet_{_v}")
