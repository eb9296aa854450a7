"""Task-aligned label assignment (TAL), the assigner behind YOLOv8 / v10 training.

Counterpart of ``yolo_puncture_tpu/train/assigner.py``.  v8 / v11 assign one to
many (top 10 anchors a box); YOLOv10's dual assignment adds a one-to-one branch
assigned with top 1.  Ground-truth boxes are padded to a fixed M with a validity
mask, and the batch is a leading dimension where the JAX package ``vmap``s.
Top-k and argmax break ties as ``jax.lax.top_k`` and ``jnp.argmax`` do: the
lower index first (a stable descending sort).
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _floor_at(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.clip(x, lo)``: max(x, lo), whose gradient splits evenly at x == lo."""
    return torch.maximum(x, x.new_tensor(lo))


def bbox_ciou(a, b, eps: float = 1e-7):
    """Complete IoU between broadcastable xyxy boxes (…, 4) → (…)."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    aw, ah = ax2 - ax1, ay2 - ay1
    bw, bh = bx2 - bx1, by2 - by1

    inter_w = _floor_at(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), 0.0)
    inter_h = _floor_at(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), 0.0)
    inter = inter_w * inter_h
    union = aw * ah + bw * bh - inter + eps
    iou = inter / union

    cw = torch.maximum(ax2, bx2) - torch.minimum(ax1, bx1)
    ch = torch.maximum(ay2, by2) - torch.minimum(ay1, by1)
    c2 = cw * cw + ch * ch + eps
    rho2 = ((bx1 + bx2 - ax1 - ax2) ** 2 + (by1 + by2 - ay1 - ay2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(bw / (bh + eps)) - torch.atan(aw / (ah + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def bbox_iou_plain(a, b, eps: float = 1e-7):
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    inter_w = _floor_at(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), 0.0)
    inter_h = _floor_at(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), 0.0)
    inter = inter_w * inter_h
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter + eps
    return inter / union


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, largest first, ties in
    index order: ``jax.lax.top_k``'s."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


@torch.no_grad()
def task_aligned_assign(
    pd_scores,      # (B, A, nc) sigmoid probabilities
    pd_bboxes,      # (B, A, 4) xyxy px
    anc_points,     # (A, 2) px
    gt_labels,      # (B, M) int
    gt_bboxes,      # (B, M, 4) xyxy px
    mask_gt,        # (B, M) bool
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
    conf_floor: float = 1e-3,
) -> Dict[str, torch.Tensor]:
    """Returns target_labels (B, A), target_bboxes (B, A, 4), target_scores
    (B, A, nc), fg_mask (B, A) bool, target_gt_idx (B, A).  The alignment metric
    is ultralytics' score^alpha · CIoU^beta over anchors inside a box; a box keeps
    its top-k anchors while its best metric, with the confidence floored at
    ``conf_floor`` for that test only, exceeds ``eps``; an anchor claimed by two
    boxes goes to the one it overlaps most; the soft target score is the metric
    normalised per box to the box's best overlap."""
    B, A, nc = pd_scores.shape
    M = gt_labels.shape[1]
    gt_labels = gt_labels.long()
    mask_gt = mask_gt.bool()
    lt = anc_points[None, None] - gt_bboxes[:, :, None, :2]            # (B, M, A, 2)
    rb = gt_bboxes[:, :, None, 2:] - anc_points[None, None]
    in_gts = torch.cat([lt, rb], -1).min(-1).values > eps               # (B, M, A)

    cls_score = torch.gather(pd_scores.transpose(1, 2), 1,
                             gt_labels.clamp_min(0)[:, :, None].expand(B, M, A))        # (B, M, A)
    overlaps = bbox_ciou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :]).clamp_min(0)
    metric = cls_score ** alpha * overlaps ** beta
    valid = in_gts & mask_gt[:, :, None]
    zero = metric.new_zeros(())
    metric = torch.where(valid, metric, zero)

    k = min(topk, A)
    topi = top_k_indices(metric, k)                                     # (B, M, k)
    gate = torch.where(valid, cls_score.clamp_min(conf_floor) ** alpha * overlaps ** beta, zero)
    gt_alive = gate.max(-1, keepdim=True).values > eps                  # (B, M, 1)
    mask_topk = torch.zeros((B, M, A), dtype=torch.bool, device=metric.device)
    mask_topk.scatter_(2, topi, gt_alive.expand(B, M, k))
    mask_pos = mask_topk & valid

    fg_counts = mask_pos.sum(1)                                         # (B, A)
    best_gt = torch.where(mask_pos, overlaps, metric.new_tensor(-1.0)).argmax(1)        # (B, A)
    rows = torch.arange(M, device=metric.device)[None, :, None]
    keep = torch.where((fg_counts > 1)[:, None, :], rows == best_gt[:, None, :], mask_pos) & mask_pos
    fg = keep.any(1)                                                    # (B, A)
    tgt_idx = keep.float().argmax(1)                            # (B, A): the first kept box, else 0

    t_labels = torch.where(fg, torch.gather(gt_labels, 1, tgt_idx), torch.zeros_like(tgt_idx))
    t_boxes = torch.gather(gt_bboxes, 1, tgt_idx[..., None].expand(B, A, 4)) * fg[..., None]

    metric_pos = metric * keep
    pos_align = metric_pos.max(-1, keepdim=True).values                 # (B, M, 1)
    pos_overlap = torch.where(keep, overlaps, zero).max(-1, keepdim=True).values
    norm = metric_pos * pos_overlap / pos_align.clamp_min(1e-30)
    anchor_score = norm.max(1).values                                   # (B, A)
    one_hot = (t_labels[..., None] == torch.arange(nc, device=metric.device)).to(metric.dtype)  # jax.nn.one_hot
    t_scores = one_hot * (anchor_score * fg)[..., None]
    return {
        "target_labels": t_labels,
        "target_bboxes": t_boxes,
        "target_scores": t_scores,
        "fg_mask": fg,
        "target_gt_idx": tgt_idx,
    }
