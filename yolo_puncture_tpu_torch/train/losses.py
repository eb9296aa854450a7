"""Detection and segmentation training losses (v8 TAL and v10 dual assignment).

Counterpart of ``yolo_puncture_tpu/train/losses.py``, the ultralytics loss: BCE
on task-aligned soft class targets, CIoU box loss and distribution focal loss,
each weighted by the target score, and for segmentation a per-positive BCE of
the prototype-mask logits inside the assigned box.  YOLOv10 adds the one-to-one
branch, assigned with top 1, without a mask term.

The head's maps come in NCHW (``nn/heads.py`` in ``train()`` mode); flattened,
they are the JAX package's (B, A, C) rows.  The mask loss takes a fixed
``max_pos`` positives per image, the largest target weights (ties in index
order, as ``jax.lax.top_k``), and forms their logits ``coeffs @ protos`` with
``torch.einsum``: a logit with a gradient, which the JAX package too computes
outside any Pallas kernel.

Inside ``nn/common.py global_batch`` (a data-parallel step) each rank
holds a shard of the global batch, and every normaliser is the global batch's:
the target-score sum of each branch and the image count of the mask loss's mean
are summed over the shards, and the total is scaled by the global batch size.
The components and the total are then this rank's shares: they sum over
the shards to the global batch's values, and so do their gradients.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from yolo_puncture_tpu_torch.nn.common import dfl_expectation, global_batch_hook
from yolo_puncture_tpu_torch.nn.heads import dist2bbox, make_anchors
from yolo_puncture_tpu_torch.train.assigner import bbox_ciou, task_aligned_assign, top_k_indices

DEFAULT_HYP = {"box": 7.5, "cls": 0.5, "dfl": 1.5, "seg": 1.0}


def _flat(feats: List[torch.Tensor]) -> torch.Tensor:
    """Per-level NCHW maps → (B, A, C), levels in order, each row-major."""
    return torch.cat([f.flatten(2).transpose(1, 2) for f in feats], dim=1)


def bbox2dist(bbox_xyxy, anchor_points, reg_max: int):
    """Inverse of ``dist2bbox`` for the DFL targets, clipped to [0, reg_max − 1.01]."""
    lt = anchor_points - bbox_xyxy[..., :2]
    rb = bbox_xyxy[..., 2:] - anchor_points
    return torch.cat([lt, rb], dim=-1).clamp(0, reg_max - 1 - 0.01)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or float64 where it is: the loss of a float64 model stays
    float64 (the JAX package takes fp32; a float64 run is a reference, and a
    data-parallel step holds it to the single-process one at float64's rounding)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def optax_sigmoid_bce(logits, labels):
    """Elementwise sigmoid BCE (stable form)."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def _dfl_loss(pred_dist, target, reg_max: int):
    """Distribution focal loss: CE to the two integer bins around the target.
    pred_dist (…, 4, reg_max) logits; target (…, 4) in [0, reg_max − 1]."""
    tl = torch.floor(target).long()
    tr = tl + 1
    wl = tr.float() - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist, dim=-1)
    ce_l = -torch.gather(logp, -1, tl.clamp(0, reg_max - 1)[..., None])[..., 0]
    ce_r = -torch.gather(logp, -1, tr.clamp(0, reg_max - 1)[..., None])[..., 0]
    return (ce_l * wl + ce_r * wr).mean(-1)


def _mask_loss(coeffs, proto, gt_masks, t_boxes, t_gt_idx, weight, max_pos: int):
    """Per image: the ``max_pos`` anchors of largest weight, their logits
    coeffs @ protos, BCE against the assigned box's mask inside the box (at
    proto resolution), summed over the box's area; mean over the positives, then
    over the batch.  coeffs (B, A, nm); proto (B, Hp, Wp, nm); gt_masks
    (B, M, Hp, Wp); t_boxes (B, A, 4) px; t_gt_idx, weight (B, A)."""
    B, A, nm = coeffs.shape
    Hp, Wp = proto.shape[1:3]
    sel = top_k_indices(weight, max_pos)                                 # (B, P)
    sel_valid = torch.gather(weight, 1, sel) > 0
    c = torch.gather(coeffs, 1, sel[..., None].expand(B, sel.shape[1], nm))
    m_pred = torch.einsum("bpn,bhwn->bphw", c, proto)                    # logits
    gt_idx = torch.gather(t_gt_idx, 1, sel)
    m_gt = torch.gather(gt_masks, 1, gt_idx[..., None, None].expand(B, sel.shape[1], Hp, Wp))
    boxes_p = torch.gather(t_boxes, 1, sel[..., None].expand(B, sel.shape[1], 4)) / 4.0
    ys = torch.arange(Hp, dtype=torch.float32, device=coeffs.device)[None, None, :, None]
    xs = torch.arange(Wp, dtype=torch.float32, device=coeffs.device)[None, None, None, :]
    bx = boxes_p[..., None, None]
    inside = (xs >= bx[:, :, 0]) & (xs < bx[:, :, 2]) & (ys >= bx[:, :, 1]) & (ys < bx[:, :, 3])
    bce = optax_sigmoid_bce(_wide(m_pred), m_gt) * inside
    area = ((boxes_p[..., 2] - boxes_p[..., 0]) * (boxes_p[..., 3] - boxes_p[..., 1])).clamp_min(1.0)
    per_pos = bce.sum((2, 3)) / area
    per_img = torch.where(sel_valid, per_pos, per_pos.new_zeros(())).sum(1) / sel_valid.sum(1).clamp_min(1)
    hook = global_batch_hook()
    if hook is not None:
        return per_img.sum() / (B * hook[1])
    return per_img.mean()


def _branch_loss(box_feats, cls_feats, batch: Dict[str, torch.Tensor], strides, nc: int, reg_max: int,
                 topk: int, hyp: Dict[str, float], coeff_feats=None, proto=None, max_pos: int = 48):
    """Loss of one head branch.  batch: gt_labels (B, M), gt_bboxes (B, M, 4)
    px, mask_gt (B, M), optional gt_masks (B, M, Hp, Wp) at proto resolution."""
    anchors, stride_t = make_anchors([f.shape[-2:] for f in box_feats], strides, device=box_feats[0].device)
    anc_px = anchors * stride_t
    box_dist, cls_logits = _flat(box_feats), _flat(cls_feats)
    B, A = cls_logits.shape[:2]
    pred_boxes = dist2bbox(dfl_expectation(box_dist, reg_max), anchors[None]) * stride_t[None]
    cls_logits = _wide(cls_logits)
    tgt = task_aligned_assign(torch.sigmoid(cls_logits).detach(), pred_boxes.detach(), anc_px,
                              batch["gt_labels"], batch["gt_bboxes"], batch["mask_gt"], topk=topk)
    fg = tgt["fg_mask"]
    t_scores = tgt["target_scores"]
    score_sum = t_scores.sum()
    hook = global_batch_hook()
    if hook is not None:
        score_sum = hook[0](score_sum)
    score_sum = score_sum.clamp_min(1.0)

    loss_cls = optax_sigmoid_bce(cls_logits, t_scores).sum() / score_sum
    weight = t_scores.sum(-1) * fg
    iou = bbox_ciou(pred_boxes, tgt["target_bboxes"])
    loss_box = ((1.0 - iou) * weight).sum() / score_sum
    t_dist = bbox2dist(tgt["target_bboxes"] / stride_t[None], anchors[None], reg_max)
    dfl = _dfl_loss(_wide(box_dist.reshape(B, A, 4, reg_max)), t_dist, reg_max)
    loss_dfl = (dfl * weight).sum() / score_sum
    out = {"cls": loss_cls, "box": loss_box, "dfl": loss_dfl}
    if coeff_feats is not None and proto is not None and "gt_masks" in batch:
        out["seg"] = _mask_loss(_wide(_flat(coeff_feats)), _wide(proto), _wide(batch["gt_masks"]),
                                tgt["target_bboxes"], tgt["target_gt_idx"], weight, max_pos)
    return out


def detection_loss(head_out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], nc: int,
                   hyp: Optional[Dict[str, float]] = None, strides=(8, 16, 32),
                   reg_max: int = 16) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss of one train-mode forward (segmentation and v10's one-to-one
    branch found from the head's outputs) and its components; the total is
    scaled by the batch size, as ultralytics does."""
    hyp = hyp or DEFAULT_HYP
    B = head_out["boxes"].shape[0]
    hook = global_batch_hook()
    if hook is not None:
        B *= hook[1]
    seg_args = {}
    if "proto" in head_out and "coeff_feats" in head_out:
        seg_args = {"coeff_feats": head_out["coeff_feats"], "proto": head_out["proto"]}
    main = _branch_loss(head_out["box_feats"], head_out["cls_feats"], batch, strides, nc, reg_max,
                        topk=10, hyp=hyp, **seg_args)
    losses = dict(main)
    total = hyp["box"] * main["box"] + hyp["cls"] * main["cls"] + hyp["dfl"] * main["dfl"]
    if "seg" in main:
        total = total + hyp.get("seg", 1.0) * main["seg"]
    if "one2one_box_feats" in head_out:
        o2o = _branch_loss(head_out["one2one_box_feats"], head_out["one2one_cls_feats"], batch, strides, nc,
                           reg_max, topk=1, hyp=hyp)
        for k, v in o2o.items():
            losses[f"o2o_{k}"] = v
        total = total + hyp["box"] * o2o["box"] + hyp["cls"] * o2o["cls"] + hyp["dfl"] * o2o["dfl"]
    losses["total"] = total * B
    return losses["total"], losses
