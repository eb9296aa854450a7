"""Detection and segmentation heads of the YOLO family (NCHW in, JAX layouts out).

Counterpart of ``yolo_puncture_tpu/nn/heads.py``:
  * v8 ``Detect`` ('legacy' classification branch: two plain 3×3 convs);
  * v11 ``Detect`` ('dw': depthwise-separable classification branch);
  * v10 (``one2one``): inference decodes the one-to-one branch only (NMS-free);
    the one-to-many branches are kept as parameters so checkpoints load;
  * ``Segment``: adds the Proto bank and per-anchor mask coefficients.

Outputs: ``boxes`` (B, A, 4) xyxy in input pixels, ``probs`` (B, A, nc) sigmoid,
and for Segment ``coeffs`` (B, A, nm) and ``proto`` (B, Hp, Wp, nm) (a
channels-last view of the NCHW bank).  Anchors run over levels in order, each
level row-major, as in the JAX package.

In ``train()`` mode the heads also return what the losses read
(``train/losses.py``): the per-level raw maps ``box_feats`` and ``cls_feats``
(lists of NCHW tensors; the JAX package's are NHWC), for Segment ``coeff_feats``,
and for v10 ``one2one_box_feats`` / ``one2one_cls_feats``, the one-to-one branch
computed on detached features as the JAX package ``stop_gradient``s them.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from yolo_puncture_tpu_torch.nn import quant
from yolo_puncture_tpu_torch.nn.common import ConvBN, Proto, dfl_expectation


def make_anchors(feat_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                 offset: float = 0.5, device=None):
    """Cell-centre anchors (A, 2) xy in stride units and per-anchor strides (A, 1), fp32."""
    points, stride_t = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        stride_t.append(torch.full((h * w, 1), float(s), dtype=torch.float32, device=device))
    return torch.cat(points), torch.cat(stride_t)


def dist2bbox(dist, anchor_points, xywh: bool = False):
    """ltrb distances (…, 4) + anchor centres (…, 2) → xyxy (or xywh) boxes."""
    lt, rb = dist[..., :2], dist[..., 2:]
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


def _box_branch(cin: int, c2: int, reg_max: int) -> nn.Sequential:
    return nn.Sequential(ConvBN(cin, c2, 3), ConvBN(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1))


def _cls_branch(cin: int, c3: int, nc: int, style: str) -> nn.Sequential:
    if style == "legacy":
        return nn.Sequential(ConvBN(cin, c3, 3), ConvBN(c3, c3, 3), nn.Conv2d(c3, nc, 1))
    return nn.Sequential(
        nn.Sequential(ConvBN(cin, cin, 3, g=cin), ConvBN(cin, c3, 1)),
        nn.Sequential(ConvBN(c3, c3, 3, g=c3), ConvBN(c3, c3, 1)),
        nn.Conv2d(c3, nc, 1),
    )


def _flat(f: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W, C)."""
    return f.flatten(2).transpose(1, 2)


class Detect(nn.Module):
    """Multi-level detect head; ``one2one`` adds the v10 one-to-one branches."""

    def __init__(self, nc: int, ch: Sequence[int], cls_style: str = "legacy",
                 one2one: bool = False, reg_max: int = 16, strides=(8, 16, 32)):
        super().__init__()
        self.nc, self.reg_max, self.strides, self.one2one = nc, reg_max, tuple(strides), one2one
        c2 = max(16, ch[0] // 4, 4 * reg_max)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(_box_branch(c, c2, reg_max) for c in ch)
        self.cv3 = nn.ModuleList(_cls_branch(c, c3, nc, cls_style) for c in ch)
        if one2one:
            self.one2one_cv2 = nn.ModuleList(_box_branch(c, c2, reg_max) for c in ch)
            self.one2one_cv3 = nn.ModuleList(_cls_branch(c, c3, nc, cls_style) for c in ch)

    @torch.no_grad()
    def bias_init(self):
        """The JAX package's bias init: DFL logits 1.0, class logits so that about
        5 objects per 640² image start above 0.5 (ultralytics recipe)."""
        pairs = [(self.cv2, self.cv3)]
        if self.one2one:
            pairs.append((self.one2one_cv2, self.one2one_cv3))
        for box, cls in pairs:
            for i, s in enumerate(self.strides):
                box[i][-1].bias.fill_(1.0)
                cls[i][-1].bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    def decode(self, box_feats: List[torch.Tensor], cls_feats: List[torch.Tensor]):
        """Per-level raw maps → xyxy boxes in input pixels + sigmoid class probs."""
        anchors, strides = make_anchors(
            [f.shape[-2:] for f in box_feats], self.strides, device=box_feats[0].device
        )
        box = torch.cat([_flat(f) for f in box_feats], dim=1)
        cls = torch.cat([_flat(f) for f in cls_feats], dim=1)
        dist = dfl_expectation(box, self.reg_max)
        boxes = dist2bbox(dist, anchors[None]) * strides[None]
        return boxes, torch.sigmoid(cls.float())

    def forward(self, feats: List[torch.Tensor]):
        if self.training:
            return self._train_forward(feats)
        if self.one2one and quant.recording():
            # the JAX package's eager forward runs the one-to-many branches too, so its
            # calibration records their inputs: the same keys here
            for m, f in zip([*self.cv2, *self.cv3], [*feats, *feats]):
                m(f)
        cv2, cv3 = (self.one2one_cv2, self.one2one_cv3) if self.one2one else (self.cv2, self.cv3)
        boxes, probs = self.decode(
            [m(f) for m, f in zip(cv2, feats)], [m(f) for m, f in zip(cv3, feats)]
        )
        return {"boxes": boxes, "probs": probs}

    def _train_forward(self, feats: List[torch.Tensor]):
        """Every branch, with the raw per-level maps (module docstring)."""
        out = {"box_feats": [m(f) for m, f in zip(self.cv2, feats)],
               "cls_feats": [m(f) for m, f in zip(self.cv3, feats)]}
        box, cls = out["box_feats"], out["cls_feats"]
        if self.one2one:
            detached = [f.detach() for f in feats]
            box = out["one2one_box_feats"] = [m(f) for m, f in zip(self.one2one_cv2, detached)]
            cls = out["one2one_cls_feats"] = [m(f) for m, f in zip(self.one2one_cv3, detached)]
        out["boxes"], out["probs"] = self.decode(box, cls)
        return out


class Segment(Detect):
    """Detect + prototype masks: per-anchor nm coefficients and an (Hp, Wp, nm) bank."""

    def __init__(self, nc: int, ch: Sequence[int], nm: int = 32, npr: int = 256,
                 cls_style: str = "legacy", one2one: bool = False):
        super().__init__(nc, ch, cls_style=cls_style, one2one=one2one)
        self.nm = nm
        self.proto = Proto(ch[0], npr, nm)
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(
            nn.Sequential(ConvBN(c, c4, 3), ConvBN(c4, c4, 3), nn.Conv2d(c4, nm, 1)) for c in ch
        )

    def forward(self, feats: List[torch.Tensor]):
        out = super().forward(feats)
        out["proto"] = self.proto(feats[0]).permute(0, 2, 3, 1)  # (B, Hp, Wp, nm) view
        coeff_feats = [m(f) for m, f in zip(self.cv4, feats)]
        if self.training:
            out["coeff_feats"] = coeff_feats
        out["coeffs"] = torch.cat([_flat(f) for f in coeff_feats], dim=1)
        return out
