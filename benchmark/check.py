"""The seg+track step's comparison (``systems/segtrack.py``): the program's
outputs of a step against the plain reference's on the same frames, weights
and memory.

For the detector, the program's best slot is judged by what the reference says
of it, as a served token is judged by the reference's logit for it: the
reference anchor with the program's box (and, among neighbours with nearly the
same box, the program's mask) is the program's choice.  Per frame:

  * ``choice_gap``: how far the reference's score of that anchor lies below the
    reference's best (near-tied anchors may rank either way and read ~0); where
    the program reports no detection, how far the reference's best lies above
    the threshold;
  * ``score_gap``: the program's score against the reference's for that anchor;
  * ``box_px``: the distance (L∞, letterbox pixels) between the two boxes;
  * the intersection and union of the two masks, and ``mask_gap``, 1 − their IoU.

Each per-frame number is taken at its 99th percentile over the checked frames
(3 steps of 128 or 64): a fault in 1 % of the frames or more shows, where the
largest frame alone swings from seed to seed with the random network's most
sensitive frame (PERF.md, cell correctness); ``mask_iou_gap`` pools the masks
(1 − IoU over all of them).  The tracker's numbers: ``ids_mismatch``, the share of id-map pixels
that differ, pooled, and ``ids_frame_max``, the largest share in one frame (an
answer altered in one frame of 128 moves only this one); ``state_gap``, the widest relative distance of the memory
after a step (keys, values, sensory) from the reference's after the same step
from the same memory.

How far bf16 moves the detector's scores, boxes and masks depends on the random
draw of its weights: a draw ten times as sensitive as another reads ten times
the gaps.  The witness measures that sensitivity in the same run: the fp32
reference itself on the frames with one grey level added to a third of the
pixels (``witness_frames``), judged by ``per_frame`` as the program is.  The
ratios ``score_ratio``, ``box_ratio`` and ``mask_ratio`` hold the program's
``score_gap``, ``box_px`` and pooled ``mask_iou_gap`` against the witness's, so
a draw's sensitivity cancels (PERF.md, cell correctness).  ``run.py judge``
holds each number to its limit in the cell's file (``workloads/<cell>.json``,
``limits``); a number the cell's file gives no limit is read and printed but not
compared.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference import yolo as ry
from benchmark.reference.numerics import Numerics

NAMES = ("choice_gap", "score_gap", "box_px", "mask_gap", "mask_iou_gap", "ids_mismatch", "ids_frame_max", "state_gap",
         "score_ratio", "box_ratio", "mask_ratio")
RATIOS = {"score_ratio": "score_gap", "box_ratio": "box_px", "mask_ratio": "mask_iou_gap"}
QUANTILE = 0.99
CANDIDATES, BOX_TOL = 8, 2.0


def per_frame(prog: Dict[str, torch.Tensor], head: Dict[str, torch.Tensor], conf: float, num: Numerics,
              size: int) -> Dict[str, torch.Tensor]:
    """prog: the program's best slot (boxes (B, 4), scores (B,), valid (B,), mask
    (B, S, S)); head: the reference's head outputs on the same frames (boxes
    (B, A, 4), probs (B, A, nc), coeffs (B, A, nm), proto).  Each reading (B,).

    Neighbouring anchors regress to boxes a fraction of a pixel apart, so the
    nearest box alone can name the wrong anchor: the program's anchor is taken
    among the ``CANDIDATES`` nearest boxes within ``BOX_TOL`` px of the nearest
    (or twice its distance), as the one whose mask agrees best with the
    program's."""
    dev = head["boxes"].device
    pb, ps, pv = prog["boxes"].to(dev).float(), prog["scores"].to(dev).float(), prog["valid"].to(dev).bool()
    probs = head["probs"].amax(dim=-1)                                           # (B, A)
    best = probs.amax(dim=1)
    dist = (pb[:, None, :] - head["boxes"]).abs().amax(dim=-1)                   # (B, A)
    cd, cand = dist.topk(min(CANDIDATES, dist.shape[1]), dim=1, largest=False)    # (B, k)
    near = cd <= torch.clamp(2 * cd[:, :1], min=BOX_TOL)
    rows = torch.arange(len(pb), device=dev)[:, None]
    soft = ry.soft_masks(num, head["proto"], head["coeffs"][rows, cand], size)    # (B, k, S, S)
    inside = ry.inside_boxes(head["boxes"][rows, cand], size)
    masks = (soft * inside) > 0.5
    pm = prog["mask"].to(dev).bool()[:, None]
    inter, union = (pm & masks).flatten(2).sum(2), (pm | masks).flatten(2).sum(2)
    iou = torch.where(union > 0, inter / union.clamp_min(1), torch.ones_like(inter, dtype=torch.float32))
    j = torch.where(near, iou, torch.full_like(iou, -1.0)).argmax(dim=1)          # first (nearest) among ties
    r = rows[:, 0]
    sa = probs[r, cand[r, j]]
    zero = torch.zeros_like(best)
    return {"choice_gap": torch.where(pv, best - sa, (best - conf).clamp_min(0)),
            "score_gap": torch.where(pv, (ps - sa).abs(), zero),
            "box_px": torch.where(pv, cd[r, j], zero),
            "valid": pv,
            "inter": (inter[r, j] * pv).float(),
            "union": (union[r, j] * pv).float()}


def ids_readings(prog_ids: torch.Tensor, ref_ids: torch.Tensor) -> Dict:
    """One step's id maps: the pixels that differ, in all and in the worst frame."""
    diff = (prog_ids.to(ref_ids.device) != ref_ids).flatten(1).sum(1)
    return {"ids_diff": int(diff.sum()), "ids_total": ref_ids.numel(),
            "ids_frame_max": float(diff.max()) / ref_ids[0].numel()}


def frame_numbers(frames: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The detector's numbers over every checked frame."""
    f = {k: torch.cat([x[k] for x in frames]).float() for k in frames[0]}
    valid = f["valid"].bool()
    union = float(f["union"].sum())
    seen = valid & (f["union"] > 0)
    q = lambda x: float(torch.quantile(x, QUANTILE)) if x.numel() else 0.0   # noqa: E731
    return {
        "choice_gap": q(f["choice_gap"]),
        "score_gap": q(f["score_gap"][valid]),
        "box_px": q(f["box_px"][valid]),
        "mask_gap": q(1.0 - f["inter"][seen] / f["union"][seen]),
        "mask_iou_gap": 1.0 - float(f["inter"].sum()) / union if union else 0.0,
    }


def combine(frames: List[Dict[str, torch.Tensor]], ids: List[Dict[str, int]], state_gaps: List[float]
            ) -> Dict[str, float]:
    """The numbers over every checked frame and step."""
    return {
        **frame_numbers(frames),
        "ids_mismatch": sum(x["ids_diff"] for x in ids) / sum(x["ids_total"] for x in ids),
        "ids_frame_max": max(x["ids_frame_max"] for x in ids),
        "state_gap": max(state_gaps),
    }


def witness_frames(frames_u8: torch.Tensor, seed: int) -> torch.Tensor:
    """The frames with one grey level added to a third of the pixels, drawn from the seed."""
    g = torch.Generator(device=frames_u8.device).manual_seed(int(seed) % (2 ** 63))
    bump = (torch.rand(frames_u8.shape, generator=g, device=frames_u8.device) < 1 / 3).int()
    return (frames_u8.int() + bump).clamp(0, 255).to(torch.uint8)


def witness_ratios(numbers: Dict[str, float], witness: Dict[str, float]) -> Dict[str, float]:
    """Each detector gap over the witness's (infinite where only the witness reads 0)."""
    return {r: numbers[k] / witness[k] if witness[k] > 0 else (math.inf if numbers[k] > 0 else 0.0)
            for r, k in RATIOS.items()}
