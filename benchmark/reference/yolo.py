"""YOLOv10 segmentation in plain fp32 PyTorch, with its pre- and post-processing.

The graph is the THU-MIG/yolov10 YAML of each scale (``v10_spec``), scaled as
ultralytics' ``parse_model`` scales it, with the Segment head of 32 masks and
the YAML's 256 prototype channels scaled by the width.  At inference the
one-to-one branch gives the boxes and scores (NMS-free), the one-to-many
branches are kept only so that the state dict is whole.

``detect`` is the whole detector side of the benchmark's step on uint8 BGR
frames: letterbox, forward, the top ``max_det`` (anchor, class) scores, and the
masks of the selected slots decoded as the program decodes them (sigmoid of the
prototypes' mix at prototype resolution, bilinear upsample to the letterbox,
crop by the box, ``> 0.5``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.blocks import (
    C2f, C2fCIB, PSA, SCDown, SPPF, Block, ConvBN, Proto, conv1x1,
)
from benchmark.reference.numerics import Numerics

# scale → (depth, width, max_channels), THU-MIG/yolov10's yolov10{n,s,m,b,l,x}.yaml
V10_SCALES = {
    "n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024), "m": (0.67, 0.75, 768),
    "b": (0.67, 1.00, 512), "l": (1.00, 1.00, 512), "x": (1.00, 1.25, 512),
}


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


def v10_spec(scale: str):
    """(from, repeats, block, args) rows of the scale's YAML, channels unscaled."""
    bb8 = {"n": ("C2f", (1024, True)), "s": ("C2fCIB", (1024, True, True))}.get(scale, ("C2fCIB", (1024, True)))
    bb6 = ("C2fCIB", (512, True)) if scale == "x" else ("C2f", (512, True))
    h13 = ("C2fCIB", (512, True)) if scale in ("b", "l", "x") else ("C2f", (512, False))
    h19 = ("C2f", (512, False)) if scale in ("n", "s") else ("C2fCIB", (512, True))
    h22 = ("C2fCIB", (1024, True, True)) if scale in ("n", "s") else ("C2fCIB", (1024, True))
    return [
        (-1, 1, "Conv", (64, 3, 2)), (-1, 1, "Conv", (128, 3, 2)), (-1, 3, "C2f", (128, True)),
        (-1, 1, "Conv", (256, 3, 2)), (-1, 6, "C2f", (256, True)), (-1, 1, "SCDown", (512, 3, 2)),
        (-1, 6, *bb6), (-1, 1, "SCDown", (1024, 3, 2)), (-1, 3, *bb8), (-1, 1, "SPPF", (1024, 5)),
        (-1, 1, "PSA", (1024,)), (-1, 1, "Upsample", ()), ((-1, 6), 1, "Concat", ()), (-1, 3, *h13),
        (-1, 1, "Upsample", ()), ((-1, 4), 1, "Concat", ()), (-1, 3, "C2f", (256, False)),
        (-1, 1, "Conv", (256, 3, 2)), ((-1, 13), 1, "Concat", ()), (-1, 3, *h19),
        (-1, 1, "SCDown", (512, 3, 2)), ((-1, 10), 1, "Concat", ()), (-1, 3, *h22),
        ((16, 19, 22), 1, "HEAD", ()),
    ]


def _box_branch(cin, c2, reg_max):
    return nn.Sequential(ConvBN(cin, c2, 3), ConvBN(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1))


def _cls_branch(cin, c3, nc):
    return nn.Sequential(
        nn.Sequential(ConvBN(cin, cin, 3, g=cin), ConvBN(cin, c3, 1)),
        nn.Sequential(ConvBN(c3, c3, 3, g=c3), ConvBN(c3, c3, 1)),
        nn.Conv2d(c3, nc, 1),
    )


def _run_branch(num: Numerics, seq: nn.Sequential, x):
    """A head branch: its blocks, then the last plain 1×1 conv through ``num``."""
    for m in list(seq)[:-1]:
        x = m(x)
    return conv1x1(num, seq[-1], x)


class Segment(Block):
    """YOLOv10 Segment head: one-to-many and one-to-one box and class branches,
    mask coefficients (cv4) and prototypes."""

    def __init__(self, nc, ch: Sequence[int], nm=32, npr=256, reg_max=16, strides=(8, 16, 32)):
        super().__init__()
        self.nc, self.nm, self.reg_max, self.strides = nc, nm, reg_max, tuple(strides)
        c2 = max(16, ch[0] // 4, 4 * reg_max)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(_box_branch(c, c2, reg_max) for c in ch)
        self.cv3 = nn.ModuleList(_cls_branch(c, c3, nc) for c in ch)
        self.one2one_cv2 = nn.ModuleList(_box_branch(c, c2, reg_max) for c in ch)
        self.one2one_cv3 = nn.ModuleList(_cls_branch(c, c3, nc) for c in ch)
        self.proto = Proto(ch[0], npr, nm)
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(nn.Sequential(ConvBN(c, c4, 3), ConvBN(c4, c4, 3), nn.Conv2d(c4, nm, 1)) for c in ch)

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        num = self.num
        box = [_run_branch(num, m, f) for m, f in zip(self.one2one_cv2, feats)]
        cls = [_run_branch(num, m, f) for m, f in zip(self.one2one_cv3, feats)]
        coeff = [_run_branch(num, m, f) for m, f in zip(self.cv4, feats)]
        flat = lambda fs: torch.cat([f.flatten(2).transpose(1, 2) for f in fs], dim=1)   # noqa: E731
        points, strides = [], []
        for f, s in zip(box, self.strides):
            h, w = f.shape[-2:]
            gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=f.device) + 0.5,
                                    torch.arange(w, dtype=torch.float32, device=f.device) + 0.5, indexing="ij")
            points.append(torch.stack([gx, gy], -1).reshape(-1, 2))
            strides.append(torch.full((h * w, 1), float(s), device=f.device))
        anchors, stride = torch.cat(points), torch.cat(strides)
        d = flat(box)
        d = d.reshape(*d.shape[:-1], 4, self.reg_max).softmax(-1)
        dist = (d * torch.arange(self.reg_max, dtype=torch.float32, device=d.device)).sum(-1)
        boxes = torch.cat([anchors - dist[..., :2], anchors + dist[..., 2:]], -1) * stride
        return {"boxes": boxes, "probs": torch.sigmoid(flat(cls)), "coeffs": flat(coeff),
                "proto": self.proto(feats[0])}


class YOLOv10Seg(Block):
    """The YOLOv10 segmentation graph of one scale; ``model`` is indexed as
    ultralytics' ``DetectionModel.model``.  ``forward`` takes NCHW images in [0, 1]."""

    def __init__(self, scale: str = "s", nc: int = 1, nm: int = 32, npr: int = 256):
        super().__init__()
        depth, width, max_ch = V10_SCALES[scale]
        self.spec = v10_spec(scale)
        ch, layers = [3], []
        for frm, n, block, args in self.spec:
            n = max(round(n * depth), 1) if n > 1 else n
            cins = [ch[j + 1 if j >= 0 else j] for j in (frm if isinstance(frm, tuple) else (frm,))]
            c1 = cins[0]
            c2 = make_divisible(min(args[0], max_ch) * width) if args else c1
            if block == "Conv":
                m = ConvBN(c1, c2, args[1], args[2])
            elif block == "C2f":
                m = C2f(c1, c2, n, shortcut=args[1])
            elif block == "C2fCIB":
                m = C2fCIB(c1, c2, n, shortcut=args[1], lk=len(args) > 2 and args[2])
            elif block == "SCDown":
                m = SCDown(c1, c2, args[1], args[2])
            elif block == "SPPF":
                m = SPPF(c1, c2, args[1])
            elif block == "PSA":
                m = PSA(c1, c2)
            elif block in ("Upsample", "Concat"):
                m = nn.Identity()
                c2 = sum(cins) if block == "Concat" else c1
            else:
                m = Segment(nc, cins, nm, make_divisible(min(npr, max_ch) * width))
                c2 = 0
            layers.append(m)
            ch.append(c2)
        self.model = nn.ModuleList(layers)
        self.saved = {i for frm, *_ in self.spec if isinstance(frm, tuple) for i in frm if i != -1}

    def forward(self, x):
        saved = {}
        for i, (frm, _, block, _) in enumerate(self.spec):
            inputs = [x if j == -1 else saved[j] for j in (frm if isinstance(frm, tuple) else (frm,))]
            if block == "Concat":
                x = torch.cat(inputs, 1)
            elif block == "Upsample":
                x = F.interpolate(inputs[0], scale_factor=2, mode="nearest")
            elif block == "HEAD":
                return self.model[i](inputs)
            else:
                x = self.model[i](inputs[0])
            if i in self.saved:
                saved[i] = x
        raise ValueError("the graph has no head")


# -- pre- and post-processing ------------------------------------------------------------------

def letterbox_geometry(h: int, w: int, size: int):
    """ultralytics ``LetterBox``: r = min(size/h, size/w), the resized extent
    rounded with Python's round, the padding split evenly.  (r, (new_w, new_h), (left, top))."""
    r = min(size / h, size / w)
    new_w, new_h = round(w * r), round(h * r)
    left, top = round((size - new_w) / 2 - 0.1), round((size - new_h) / 2 - 0.1)
    return r, (new_w, new_h), (left, top)


def cv2_linear_matrix(src: int, dst: int) -> np.ndarray:
    """(src, dst) weights of cv2's INTER_LINEAR resize along one axis: the source
    position (j + 0.5)·src/dst − 0.5 between its two neighbours, clamped at the edges."""
    m = np.zeros((src, dst), np.float64)
    for j in range(dst):
        x = (j + 0.5) * src / dst - 0.5
        i0 = math.floor(x)
        f = x - i0
        m[min(max(i0, 0), src - 1), j] += 1.0 - f
        m[min(max(i0 + 1, 0), src - 1), j] += f
    return m.astype(np.float32)


def letterbox(frames_u8: torch.Tensor, size: int) -> torch.Tensor:
    """BGR uint8 (B, H, W, 3) → RGB (B, 3, size, size) fp32 in [0, 1]: cv2's linear
    resize into the centre, padded with 114/255."""
    B, H, W, _ = frames_u8.shape
    _, (new_w, new_h), (left, top) = letterbox_geometry(H, W, size)
    x = frames_u8.permute(0, 3, 1, 2).float() / 255.0
    mh = torch.from_numpy(cv2_linear_matrix(H, new_h)).to(x.device)
    mw = torch.from_numpy(cv2_linear_matrix(W, new_w)).to(x.device)
    x = torch.matmul(mh.T, torch.matmul(x, mw)).flip(1)
    out = torch.full((B, 3, size, size), 114.0 / 255.0, device=x.device)
    out[:, :, top:top + new_h, left:left + new_w] = x
    return out


def half_pixel_matrix(src: int, dst: int, device) -> torch.Tensor:
    """(src, dst) bilinear upsampling weights with half-pixel centres."""
    return torch.from_numpy(cv2_linear_matrix(src, dst)).to(device)


def select_top(head: Dict[str, torch.Tensor], conf: float, max_det: int):
    """The top ``max_det`` (anchor, class) scores per image, ties to the lower
    index.  Returns boxes (B, k, 4), scores (B, k), valid (B, k), anchors (B, k)."""
    B, A, nc = head["probs"].shape
    scores, idx = torch.sort(head["probs"].reshape(B, A * nc), dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :max_det], idx[:, :max_det]
    anchors = idx // nc
    boxes = torch.gather(head["boxes"], 1, anchors[..., None].expand(-1, -1, 4))
    return boxes, scores, scores >= conf, anchors


def soft_masks(num: Numerics, proto: torch.Tensor, coeffs: torch.Tensor, size: int) -> torch.Tensor:
    """The selected slots' soft masks at the letterbox's resolution: sigmoid of
    the prototypes' mix at prototype resolution, upsampled bilinearly.
    proto (B, nm, Hp, Wp); coeffs (B, k, nm) → (B, k, size, size)."""
    B, nm, Hp, Wp = proto.shape
    soft = torch.sigmoid(num.matmul(coeffs, proto.reshape(B, nm, Hp * Wp))).reshape(B, -1, Hp, Wp)
    return torch.matmul(half_pixel_matrix(Hp, size, proto.device).T,
                        torch.matmul(soft, half_pixel_matrix(Wp, size, proto.device)))


def inside_boxes(boxes: torch.Tensor, size: int) -> torch.Tensor:
    """(B, k, size, size) bool: the pixel lies in the half-open box."""
    pix = torch.arange(size, dtype=torch.float32, device=boxes.device)
    x1, y1, x2, y2 = (boxes[..., i, None, None] for i in range(4))
    return (pix[None, None, None, :] >= x1) & (pix[None, None, None, :] < x2) \
        & (pix[None, None, :, None] >= y1) & (pix[None, None, :, None] < y2)


def decode_masks(num: Numerics, proto: torch.Tensor, coeffs: torch.Tensor, boxes: torch.Tensor, size: int):
    """Masks of the selected slots: ``soft_masks`` cropped to the box (half-open
    in pixels), ``> 0.5``.  boxes (B, k, 4) → bool (B, k, size, size)."""
    return (soft_masks(num, proto, coeffs, size) * inside_boxes(boxes, size)) > 0.5


@torch.no_grad()
def head_outputs(model: YOLOv10Seg, frames_u8: torch.Tensor, size: int) -> Dict[str, torch.Tensor]:
    """The head's outputs on BGR uint8 frames: every anchor's box, score and mask
    coefficients, and the prototypes."""
    return model(letterbox(frames_u8, size))


@torch.no_grad()
def detect(model: YOLOv10Seg, frames_u8: torch.Tensor, size: int, conf: float, max_det: int,
           mask_slots: int = None):
    """The detector side of one step on BGR uint8 frames (B, H, W, 3): every
    selected slot's box, score and validity, and the masks of the first
    ``mask_slots`` slots (all by default; ``select_top``, ``decode_masks``);
    invalid slots keep their box and mask."""
    head = model(letterbox(frames_u8, size))
    boxes, scores, valid, anchors = select_top(head, conf, max_det)
    n = max_det if mask_slots is None else mask_slots
    coeffs = torch.gather(head["coeffs"], 1, anchors[:, :n, None].expand(-1, -1, head["coeffs"].shape[-1]))
    masks = decode_masks(model.num, head["proto"], coeffs, boxes[:, :n], size)
    return {"boxes": boxes, "scores": scores, "valid": valid, "masks": masks}
