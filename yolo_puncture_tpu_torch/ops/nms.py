"""Detection selection: v8/v11 NMS and v10 NMS-free top-k, padded to ``max_det``.

Counterpart of ``yolo_puncture_tpu/ops/nms.py``.  Both selectors return
``max_det`` slots per image with ``valid`` masks and a ``count``; invalid slots
hold zero boxes and scores and class/index -1.  Ranking uses a stable
descending sort, so ties go to the lowest index as ``lax.top_k`` does
(``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _top_k(x: torch.Tensor, k: int):
    """Largest k along the last dim, ties broken toward the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def box_iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (N, 4) and (M, 4) xyxy boxes."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-9)


def _nms_single(boxes, scores, classes, iou_thres: float, max_det: int,
                class_agnostic: bool = False, pre_topk: int = 1024) -> Dict[str, torch.Tensor]:
    """Greedy NMS on one image: boxes (A, 4) xyxy, scores (A,), classes (A,) int32.
    Candidates are cut to the ``pre_topk`` best first; the sequential sweep runs
    on the host over the (k, k) suppression matrix computed on the device."""
    A = scores.shape[0]
    k = min(pre_topk, A)
    top_scores, order = _top_k(scores, k)
    top_boxes, top_classes = boxes[order], classes[order]
    if class_agnostic:
        nms_boxes = top_boxes
    else:  # offset boxes per class so boxes of different classes never overlap
        nms_boxes = top_boxes + top_classes.to(top_boxes.dtype)[:, None] * (boxes.max() + 1.0)
    over = (box_iou_xyxy(nms_boxes, nms_boxes) > iou_thres).cpu().numpy()
    keep = np.ones(k, dtype=bool)
    for i in range(k):
        if keep[i]:
            keep[i + 1:] &= ~over[i, i + 1:]
    keep = torch.from_numpy(keep).to(scores.device) & (top_scores > 0)

    keep_scores = torch.where(keep, top_scores, torch.full_like(top_scores, -1.0))
    kk = min(max_det, k)
    sel_scores, sel_idx = _top_k(keep_scores, kk)
    if max_det > kk:
        sel_scores = torch.cat([sel_scores, sel_scores.new_full((max_det - kk,), -1.0)])
        sel_idx = torch.cat([sel_idx, sel_idx.new_zeros(max_det - kk)])
    valid = sel_scores > 0
    return {
        "boxes": torch.where(valid[:, None], top_boxes[sel_idx], torch.zeros_like(top_boxes[sel_idx])),
        "scores": torch.where(valid, sel_scores, torch.zeros_like(sel_scores)),
        "classes": torch.where(valid, top_classes[sel_idx], torch.full_like(top_classes[sel_idx], -1)),
        "indices": torch.where(valid, order[sel_idx], torch.full_like(order[sel_idx], -1)),
        "valid": valid,
        "count": valid.sum().to(torch.int32),
    }


def batched_nms(boxes, probs, conf_thres: float = 0.25, iou_thres: float = 0.7,
                max_det: int = 300, class_agnostic: bool = False) -> Dict[str, torch.Tensor]:
    """v8/v11 postprocess.  boxes (B, A, 4), probs (B, A, nc) sigmoid scores.
    Per-anchor class = argmax; anchors below ``conf_thres`` are dropped before NMS."""
    scores, classes = probs.amax(dim=-1), probs.argmax(dim=-1)
    scores = torch.where(scores >= conf_thres, scores, torch.zeros_like(scores))
    per_image = [
        _nms_single(b, s, c.to(torch.int32), iou_thres, max_det, class_agnostic)
        for b, s, c in zip(boxes, scores, classes)
    ]
    return {key: torch.stack([d[key] for d in per_image]) for key in per_image[0]}


def v10_topk_select(boxes, probs, conf_thres: float = 0.25,
                    max_det: int = 300) -> Dict[str, torch.Tensor]:
    """YOLOv10 NMS-free selection: the global top ``max_det`` of the (anchor, class)
    scores; an anchor may appear once per class (ultralytics v10postprocess)."""
    B, A, nc = probs.shape
    k = min(max_det, A * nc)
    sel_scores, idx = _top_k(probs.reshape(B, A * nc), k)
    if k < max_det:
        sel_scores = torch.cat([sel_scores, sel_scores.new_full((B, max_det - k), -1.0)], dim=1)
        idx = torch.cat([idx, idx.new_zeros((B, max_det - k))], dim=1)
    anchor = idx // nc
    cls = (idx % nc).to(torch.int32)
    valid = sel_scores >= conf_thres
    sel_boxes = torch.gather(boxes, 1, anchor[..., None].expand(-1, -1, 4))
    return {
        "boxes": torch.where(valid[..., None], sel_boxes, torch.zeros_like(sel_boxes)),
        "scores": torch.where(valid, sel_scores, torch.zeros_like(sel_scores)),
        "classes": torch.where(valid, cls, torch.full_like(cls, -1)),
        "indices": torch.where(valid, anchor, torch.full_like(anchor, -1)),
        "valid": valid,
        "count": valid.sum(dim=-1).to(torch.int32),
    }


def select_detections(head_out: Dict[str, torch.Tensor], nms_free: bool, conf_thres: float,
                      iou_thres: float = 0.7, max_det: int = 300) -> Dict[str, torch.Tensor]:
    """Dispatch on head type; gathers the selected anchors' mask coefficients."""
    boxes, probs = head_out["boxes"], head_out["probs"]
    if nms_free:
        det = v10_topk_select(boxes, probs, conf_thres, max_det)
    else:
        det = batched_nms(boxes, probs, conf_thres, iou_thres, max_det)
    if "coeffs" in head_out:
        coeffs = head_out["coeffs"]
        idx = det["indices"].clamp(min=0).long()
        gathered = torch.gather(coeffs, 1, idx[..., None].expand(-1, -1, coeffs.shape[-1]))
        det["coeffs"] = gathered * det["valid"][..., None]
    return det
