"""Box / mask mAP50 and mAP50-95 evaluation (host numpy).

Counterpart of ``yolo_puncture_tpu/train/metrics.py`` (the port keeps its own
copy): per-image greedy matching at IoU thresholds 0.50:0.95:0.05, AP by the
ultralytics continuous precision-recall integration (101-point interpolation).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy 2 renamed it


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def mask_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (N, H, W), b (M, H, W) binary → (N, M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    af = a.reshape(len(a), -1).astype(bool)
    bf = b.reshape(len(b), -1).astype(bool)
    inter = af.astype(np.float32) @ bf.astype(np.float32).T
    union = af.sum(1)[:, None] + bf.sum(1)[None] - inter
    return inter / np.maximum(union, 1e-9)


def _match_image(iou: np.ndarray, pred_cls, gt_cls, thresholds) -> np.ndarray:
    """Greedy per-threshold matching → tp matrix (n_pred, n_thr)."""
    n_pred = iou.shape[0]
    tp = np.zeros((n_pred, len(thresholds)), bool)
    if iou.size == 0:
        return tp
    correct_class = pred_cls[:, None] == gt_cls[None, :]
    for t, thr in enumerate(thresholds):
        cand = (iou >= thr) & correct_class
        if not cand.any():
            continue
        ious = np.where(cand, iou, 0)
        # greedy: best matches first, one gt per pred
        order = np.argsort(-ious, axis=None)
        used_pred, used_gt = set(), set()
        for flat in order:
            p, g = np.unravel_index(flat, ious.shape)
            if ious[p, g] < thr:
                break
            if p in used_pred or g in used_gt:
                continue
            used_pred.add(p)
            used_gt.add(g)
            tp[p, t] = True
    return tp


def _ap_per_class(tp, conf, pred_cls, target_cls, eps: float = 1e-16):
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    classes = np.unique(target_cls)
    n_thr = tp.shape[1]
    ap = np.zeros((len(classes), n_thr))
    for ci, c in enumerate(classes):
        sel = pred_cls == c
        n_gt = (target_cls == c).sum()
        if n_gt == 0 or sel.sum() == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_gt + eps)
        precision = tpc / (tpc + fpc)
        for t in range(n_thr):
            mrec = np.concatenate(([0.0], recall[:, t], [1.0]))
            mpre = np.concatenate(([1.0], precision[:, t], [0.0]))
            mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
            x = np.linspace(0, 1, 101)
            ap[ci, t] = _trapezoid(np.interp(x, mrec, mpre), x)
    return ap, classes


def compute_map(
    predictions: Sequence[Dict],
    ground_truths: Sequence[Dict],
    use_masks: bool = False,
) -> Dict[str, float]:
    """predictions[i]: {boxes (N,4), scores (N,), classes (N,), masks (N,H,W)?}
    ground_truths[i]: {boxes (M,4), classes (M,), masks (M,H,W)?}
    Returns {'map50': …, 'map50_95': …, 'precision', 'recall'}."""
    thresholds = np.arange(0.5, 0.96, 0.05)
    all_tp, all_conf, all_pcls, all_tcls = [], [], [], []
    for pred, gt in zip(predictions, ground_truths):
        p_boxes = np.asarray(pred.get("boxes", np.zeros((0, 4))))
        p_conf = np.asarray(pred.get("scores", np.zeros(0)))
        p_cls = np.asarray(pred.get("classes", np.zeros(0)))
        g_boxes = np.asarray(gt.get("boxes", np.zeros((0, 4))))
        g_cls = np.asarray(gt.get("classes", np.zeros(0)))
        if use_masks:
            iou = mask_iou_np(
                np.asarray(pred.get("masks", np.zeros((0, 1, 1)))),
                np.asarray(gt.get("masks", np.zeros((0, 1, 1)))),
            )
        else:
            iou = box_iou_np(p_boxes, g_boxes)
        all_tp.append(_match_image(iou, p_cls, g_cls, thresholds))
        all_conf.append(p_conf)
        all_pcls.append(p_cls)
        all_tcls.append(g_cls)

    tp = np.concatenate(all_tp) if all_tp else np.zeros((0, len(thresholds)))
    conf = np.concatenate(all_conf) if all_conf else np.zeros(0)
    pcls = np.concatenate(all_pcls) if all_pcls else np.zeros(0)
    tcls = np.concatenate(all_tcls) if all_tcls else np.zeros(0)
    if len(tcls) == 0:
        return {"map50": 0.0, "map50_95": 0.0, "precision": 0.0, "recall": 0.0}
    ap, classes = _ap_per_class(tp, conf, pcls, tcls)
    n_gt_total = len(tcls)
    recall = tp[:, 0].sum() / max(n_gt_total, 1)
    precision = tp[:, 0].sum() / max(len(conf), 1)
    return {
        "map50": float(ap[:, 0].mean()) if len(ap) else 0.0,
        "map50_95": float(ap.mean()) if len(ap) else 0.0,
        "precision": float(precision),
        "recall": float(recall),
    }
