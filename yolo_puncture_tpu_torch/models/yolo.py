"""YOLO v8 / v10 / v11 detection and segmentation models (NCHW inside).

Counterpart of ``yolo_puncture_tpu/models/yolo.py``, with the port's own copy of
its architecture tables (``SCALES``, ``V8_SPEC``, ``V11_SPEC``, ``_v10_spec``,
``make_divisible``).  ``YOLOModel.model`` is a ModuleList indexed like
ultralytics' ``DetectionModel.model``, so state-dict keys are ``model.{i}.…``.

``forward`` takes NHWC images in [0, 1] (the JAX package's layout), runs NCHW
in the model's ``dtype`` (fp32, or bf16 as the JAX package's
``dtype=bfloat16``: ``nn/common.py to_compute_dtype``), and returns the head's
dict in the JAX layouts: ``boxes`` (B, A, 4), ``probs`` (B, A, nc), for
segmentation ``coeffs`` (B, A, nm), ``proto`` (B, Hp, Wp, nm), and
``pyramid`` = {P3, P4, P5}, the head's three inputs (B, h, w, C) as
channels-last views (the shared-backbone tracker reads them;
``pyramid_channels_for`` gives their widths).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolo_puncture_tpu_torch.nn.common import (
    C2PSA,
    C2f,
    C2fCIB,
    C3k2,
    ConvBN,
    PSA,
    SCDown,
    SPPF,
    to_compute_dtype,
    upsample_nearest_2x,
)
from yolo_puncture_tpu_torch.nn.heads import Detect, Segment


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


# Entry: (from, repeats, block, args), channels before width scaling.  Tuple
# 'from' entries name earlier layer outputs (Concat / HEAD), as in the
# ultralytics YAML graphs.
V8_SPEC = [
    (-1, 1, "Conv", (64, 3, 2)),        # 0 P1/2
    (-1, 1, "Conv", (128, 3, 2)),       # 1 P2/4
    (-1, 3, "C2f", (128, True)),        # 2
    (-1, 1, "Conv", (256, 3, 2)),       # 3 P3/8
    (-1, 6, "C2f", (256, True)),        # 4
    (-1, 1, "Conv", (512, 3, 2)),       # 5 P4/16
    (-1, 6, "C2f", (512, True)),        # 6
    (-1, 1, "Conv", (1024, 3, 2)),      # 7 P5/32
    (-1, 3, "C2f", (1024, True)),       # 8
    (-1, 1, "SPPF", (1024, 5)),         # 9
    (-1, 1, "Upsample", ()),            # 10
    ((-1, 6), 1, "Concat", ()),         # 11
    (-1, 3, "C2f", (512, False)),       # 12
    (-1, 1, "Upsample", ()),            # 13
    ((-1, 4), 1, "Concat", ()),         # 14
    (-1, 3, "C2f", (256, False)),       # 15 P3
    (-1, 1, "Conv", (256, 3, 2)),       # 16
    ((-1, 12), 1, "Concat", ()),        # 17
    (-1, 3, "C2f", (512, False)),       # 18 P4
    (-1, 1, "Conv", (512, 3, 2)),       # 19
    ((-1, 9), 1, "Concat", ()),         # 20
    (-1, 3, "C2f", (1024, False)),      # 21 P5
    ((15, 18, 21), 1, "HEAD", ()),      # 22
]


def _v10_spec(scale: str):
    # n/s use a large-kernel CIB in the last head stage; s+ swap backbone stage 8
    # to CIB, but only s keeps the large kernel there (yolov10m/b/l/x yamls say
    # C2fCIB [1024, True]).  The CIB allocation grows with scale (yolov10 yamls).
    if scale == "n":
        bb8 = ("C2f", (1024, True))
    elif scale == "s":
        bb8 = ("C2fCIB", (1024, True, True))
    else:
        bb8 = ("C2fCIB", (1024, True))
    bb6 = ("C2fCIB", (512, True)) if scale == "x" else ("C2f", (512, True))
    h13 = ("C2fCIB", (512, True)) if scale in ("b", "l", "x") else ("C2f", (512, False))
    if scale in ("n", "s"):
        h19 = ("C2f", (512, False))
        h22 = ("C2fCIB", (1024, True, True))
    else:
        h19 = ("C2fCIB", (512, True))
        h22 = ("C2fCIB", (1024, True))
    return [
        (-1, 1, "Conv", (64, 3, 2)),        # 0
        (-1, 1, "Conv", (128, 3, 2)),       # 1
        (-1, 3, "C2f", (128, True)),        # 2
        (-1, 1, "Conv", (256, 3, 2)),       # 3
        (-1, 6, "C2f", (256, True)),        # 4
        (-1, 1, "SCDown", (512, 3, 2)),     # 5
        (-1, 6, bb6[0], bb6[1]),            # 6
        (-1, 1, "SCDown", (1024, 3, 2)),    # 7
        (-1, 3, bb8[0], bb8[1]),            # 8
        (-1, 1, "SPPF", (1024, 5)),         # 9
        (-1, 1, "PSA", (1024,)),            # 10
        (-1, 1, "Upsample", ()),            # 11
        ((-1, 6), 1, "Concat", ()),         # 12
        (-1, 3, h13[0], h13[1]),            # 13
        (-1, 1, "Upsample", ()),            # 14
        ((-1, 4), 1, "Concat", ()),         # 15
        (-1, 3, "C2f", (256, False)),       # 16 P3
        (-1, 1, "Conv", (256, 3, 2)),       # 17
        ((-1, 13), 1, "Concat", ()),        # 18
        (-1, 3, h19[0], h19[1]),            # 19 P4
        (-1, 1, "SCDown", (512, 3, 2)),     # 20
        ((-1, 10), 1, "Concat", ()),        # 21
        (-1, 3, h22[0], h22[1]),            # 22 P5
        ((16, 19, 22), 1, "HEAD", ()),      # 23
    ]


V11_SPEC = [
    (-1, 1, "Conv", (64, 3, 2)),               # 0
    (-1, 1, "Conv", (128, 3, 2)),              # 1
    (-1, 2, "C3k2", (256, False, 0.25)),       # 2
    (-1, 1, "Conv", (256, 3, 2)),              # 3
    (-1, 2, "C3k2", (512, False, 0.25)),       # 4
    (-1, 1, "Conv", (512, 3, 2)),              # 5
    (-1, 2, "C3k2", (512, True)),              # 6
    (-1, 1, "Conv", (1024, 3, 2)),             # 7
    (-1, 2, "C3k2", (1024, True)),             # 8
    (-1, 1, "SPPF", (1024, 5)),                # 9
    (-1, 2, "C2PSA", (1024,)),                 # 10
    (-1, 1, "Upsample", ()),                   # 11
    ((-1, 6), 1, "Concat", ()),                # 12
    (-1, 2, "C3k2", (512, False)),             # 13
    (-1, 1, "Upsample", ()),                   # 14
    ((-1, 4), 1, "Concat", ()),                # 15
    (-1, 2, "C3k2", (256, False)),             # 16 P3
    (-1, 1, "Conv", (256, 3, 2)),              # 17
    ((-1, 13), 1, "Concat", ()),               # 18
    (-1, 2, "C3k2", (512, False)),             # 19 P4
    (-1, 1, "Conv", (512, 3, 2)),              # 20
    ((-1, 10), 1, "Concat", ()),               # 21
    (-1, 2, "C3k2", (1024, True)),             # 22 P5
    ((16, 19, 22), 1, "HEAD", ()),             # 23
]

# scale → (depth, width, max_channels)
SCALES = {
    "v8": {
        "n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024), "m": (0.67, 0.75, 768),
        "l": (1.00, 1.00, 512), "x": (1.00, 1.25, 512),
    },
    "v10": {
        "n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024), "m": (0.67, 0.75, 768),
        "b": (0.67, 1.00, 512), "l": (1.00, 1.00, 512), "x": (1.00, 1.25, 512),
    },
    "v11": {
        "n": (0.50, 0.25, 1024), "s": (0.50, 0.50, 1024), "m": (0.50, 1.00, 512),
        "l": (1.00, 1.00, 512), "x": (1.00, 1.50, 512),
    },
}

# v11 C3k2 turns c3k on for m/l/x even where the spec says False.
_V11_FORCE_C3K = {"m", "l", "x"}


def pyramid_channels_for(version: str = "v10", scale: str = "s") -> Tuple[int, int, int]:
    """(C3, C4, C5), the widths of the P3/P4/P5 pyramid of a detector scale: what
    ``TrackerCore(pyramid_channels=...)`` takes so that its adapter's 1×1
    projections fit the backbone that feeds them."""
    _, width, max_ch = SCALES[version][scale]
    return tuple(make_divisible(min(c, max_ch) * width, 8) for c in (256, 512, 1024))


def _spec(version: str, scale: str):
    if version == "v8":
        return V8_SPEC
    if version == "v10":
        return _v10_spec(scale)
    if version == "v11":
        return V11_SPEC
    raise ValueError(f"unknown version {version}")


class YOLOModel(nn.Module):
    """Spec-driven YOLO graph for ``version`` 'v8' | 'v10' | 'v11', ``task``
    'detect' | 'segment', computing in ``dtype`` (fp32 or bf16).  The head's
    boxes and class scores come out fp32 whatever ``dtype`` is (the DFL softmax,
    the fp32 anchors and strides, the sigmoid of fp32 class logits); its mask
    coefficients and prototypes in ``dtype``."""

    def __init__(self, version: str = "v10", scale: str = "s", nc: int = 80,
                 task: str = "segment", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.version, self.scale, self.nc, self.task, self.dtype = version, scale, nc, task, dtype
        depth, width, max_ch = SCALES[version][scale]
        self.spec = _spec(version, scale)

        def scale_ch(c):
            return make_divisible(min(c, max_ch) * width, 8)

        layers: List[nn.Module] = []
        ch: List[int] = [3]  # ch[i + 1] is layer i's output width
        for frm, n, block, args in self.spec:
            n_scaled = max(round(n * depth), 1) if n > 1 else n
            cins = [ch[j + 1 if j >= 0 else j] for j in (frm if isinstance(frm, tuple) else (frm,))]
            c1 = cins[0]
            c2 = scale_ch(args[0]) if args else c1
            if block == "Conv":
                m = ConvBN(c1, c2, args[1], args[2])
            elif block == "C2f":
                m = C2f(c1, c2, n_scaled, shortcut=args[1])
            elif block == "C2fCIB":
                m = C2fCIB(c1, c2, n_scaled, shortcut=args[1], lk=len(args) > 2 and args[2])
            elif block == "C3k2":
                c3k = args[1] or scale in _V11_FORCE_C3K
                m = C3k2(c1, c2, n_scaled, c3k=c3k, e=args[2] if len(args) > 2 else 0.5)
            elif block == "SPPF":
                m = SPPF(c1, c2, args[1])
            elif block == "SCDown":
                m = SCDown(c1, c2, args[1], args[2])
            elif block == "PSA":
                m = PSA(c1, c2)
            elif block == "C2PSA":
                m = C2PSA(c1, c2, n_scaled)
            elif block in ("Upsample", "Concat"):
                m = nn.Identity()  # wiring only, no parameters
                c2 = sum(cins) if block == "Concat" else c1
            elif block == "HEAD":
                one2one = version == "v10"
                cls_style = "legacy" if version == "v8" else "dw"
                if task == "segment":
                    m = Segment(nc, cins, nm=32, npr=scale_ch(256), cls_style=cls_style,
                                one2one=one2one)
                else:
                    m = Detect(nc, cins, cls_style=cls_style, one2one=one2one)
                c2 = 0
            else:
                raise ValueError(f"unknown block {block}")
            layers.append(m)
            ch.append(c2)
        self.model = nn.ModuleList(layers)
        self._needed = {i for frm, *_ in self.spec if isinstance(frm, tuple) for i in frm if i != -1}
        to_compute_dtype(self, dtype)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "YOLOModel":
        """Seeded random init: LeCun-normal conv kernels, zero conv biases, the
        head's bias init, and BatchNorm running statistics taken from one
        train-mode forward of seeded noise.  With identity statistics the
        activations shrink layer by layer until the head sees zeros (every score
        equals the class bias, every mask is empty); batch statistics keep each
        layer near unit scale, so a random model gives varied scores and masks.
        The init runs in fp32 whatever ``dtype`` is, so that a bf16 model holds
        the fp32 model's weights rounded to bf16."""
        to_compute_dtype(self, torch.float32)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = w[0].numel() if isinstance(m, nn.Conv2d) else w.shape[0] * w[0, 0].numel()
                w.copy_(torch.randn(w.shape, generator=generator) * math.sqrt(1.0 / fan_in))
                if m.bias is not None:
                    m.bias.zero_()
        self.model[-1].bias_init()
        bns = [m for m in self.modules() if isinstance(m, nn.BatchNorm2d)]
        for m in bns:
            m.reset_parameters()
            m.momentum = 1.0  # running statistics := this batch's statistics
        # seeded images with both fine and coarse content: white noise, smooth
        # fields, and blocks with sharp edges
        g = generator
        images = torch.cat([
            torch.rand((2, 3, 256, 256), generator=g),
            F.interpolate(torch.rand((2, 3, 8, 8), generator=g), size=(256, 256), mode="bilinear"),
            F.interpolate(torch.rand((2, 3, 8, 8), generator=g), size=(256, 256), mode="nearest"),
        ])
        self.train()
        self._forward(images.permute(0, 2, 3, 1).to(next(self.parameters()).device))
        self.eval()
        for m in bns:
            m.momentum = 0.03
        to_compute_dtype(self, self.dtype)
        return self

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._forward(x.to(self.dtype))

    def _forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).contiguous()  # NHWC → NCHW
        saved: Dict[int, torch.Tensor] = {}
        out: Optional[Dict[str, torch.Tensor]] = None
        for i, (frm, _, block, _) in enumerate(self.spec):
            if isinstance(frm, tuple):
                inputs = [x if j == -1 else saved[j] for j in frm]
            else:
                inputs = [x if frm == -1 else saved[frm]]
            if block == "Concat":
                x = torch.cat(inputs, 1)
            elif block == "Upsample":
                x = upsample_nearest_2x(inputs[0])
            elif block == "HEAD":
                out = self.model[i](inputs)
                out["pyramid"] = {k: t.permute(0, 2, 3, 1) for k, t in zip(("P3", "P4", "P5"), inputs)}
            else:
                x = self.model[i](inputs[0])
            if i in self._needed:
                saved[i] = x
        return out
