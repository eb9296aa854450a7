"""Tracker propagation quality on the shipped checkpoint: the port's run of the
protocol of ``tools/eval_tracker_quality.py`` (results: ``docs/tracker_quality.md``).

    python -m yolo_puncture_tpu_torch.track.quality [--clips 16] [--frames 32]
        [--height 240] [--width 432] [--device cpu]

Sixteen held-out clips of 32 frames at 240×432 (``make_realistic_clip``, seed 7:
a textured drifting background, rotated shrinking needle-like bars, half the
clips with a second crossing bar, half of each group with a dark occluder), each
propagated from its frame-0 ground truth with
``resources/weights/tracker_propagation.msgpack``; the score is the mean
per-frame, per-object IoU against the ground truth over frames 1..T-1 (objects
with an empty ground truth skipped).  Three rows of the table:

  * "base (per-frame, fp32)": ``step`` frame by frame;
  * "bench-exact": bf16, ``affinity_bf16=True``, exact windows of 4
    (``propagate_frames``), a trailing partial window frame by frame;
  * "int8 memory": the base row's tracker with ``quantized_memory=True`` (the
    int8 working ring and its dense int8 readout), frame by frame.

The JAX package records 0.662, 0.662 and 0.663 (``JAX_MEAN_IOU``).  The card's machine
has no JAX, so ``make_realistic_clip`` and ``_iou`` are numpy/scipy copies of
the tool's, equal to them bit for bit for the same generator.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from yolo_puncture_tpu_torch.ops.masks import upsample_bilinear_matmul
from yolo_puncture_tpu_torch.track.core import TrackerCore
from yolo_puncture_tpu_torch.track.network import soft_aggregate

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                       "resources", "weights", "tracker_propagation.msgpack")
JAX_MEAN_IOU = {"base (per-frame, fp32)": 0.662, "bench-exact": 0.662,   # docs/tracker_quality.md
                "int8 memory": 0.663}


def make_realistic_clip(rng, T, h, w, shrink=True, n_objects=1, occluder=False):
    """Needle-like rotated bar(s) over a textured drifting background
    (``tools/eval_tracker_quality.py make_realistic_clip``, the same draws from
    ``rng`` in the same order).  ``n_objects=2`` adds a second bar that crosses
    the first (where they cross, the later-drawn bar owns the pixel);
    ``occluder=True`` sweeps a dark ellipse across the scene, whose pixels
    belong to no object.  Returns images (T, h, w, 3) float32 in [0, 1] and
    masks (T, n_objects, h, w) float32 {0, 1}."""
    from scipy.signal import convolve2d

    base = rng.uniform(0.2, 0.6, size=(h + 40, w + 40, 3)).astype(np.float32)
    k = np.ones((9, 9), np.float32) / 81.0
    for c in range(3):
        base[..., c] = convolve2d(base[..., c], k, mode="same", boundary="symm")
    gy = np.linspace(0, 0.15, h + 40)[:, None, None]
    base = np.clip(base + gy, 0, 1)

    objs = []
    for k in range(n_objects):
        objs.append(dict(
            cx=w * rng.uniform(0.3, 0.7), cy=h * rng.uniform(0.3, 0.7),
            angle=rng.uniform(-0.5, 0.5) + (1.1 if k else 0.0),
            length=min(h, w) * rng.uniform(0.55, 0.8),
            width=max(3.0, min(h, w) * 0.06),
            vx=rng.uniform(-2.0, 2.0), vy=rng.uniform(-1.5, 1.5),
            va=rng.uniform(-0.02, 0.02),
            color=rng.uniform(0.75, 0.95, size=3),
        ))
    if occluder:
        occ = dict(
            cy=h * rng.uniform(0.35, 0.65), ry=h * rng.uniform(0.18, 0.3),
            rx=w * rng.uniform(0.10, 0.16),
            shade=rng.uniform(0.05, 0.18, size=3),
        )

    images = np.zeros((T, h, w, 3), np.float32)
    masks = np.zeros((T, n_objects, h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for t in range(T):
        ox, oy = int(2 * t) % 40, int(1 * t) % 40
        img = base[oy:oy + h, ox:ox + w].copy()
        img *= rng.uniform(0.92, 1.08)
        frame_ms = []
        for k, o in enumerate(objs):
            a = o["angle"] + o["va"] * t
            ca, sa = np.cos(a), np.sin(a)
            lcur = o["length"] * (1.0 - (0.04 * t if shrink and k == 0 else 0.0))
            u = (xx - (o["cx"] + o["vx"] * t)) * ca + (yy - (o["cy"] + o["vy"] * t)) * sa
            v = -(xx - (o["cx"] + o["vx"] * t)) * sa + (yy - (o["cy"] + o["vy"] * t)) * ca
            m = (np.abs(u) < lcur / 2) & (np.abs(v) < o["width"] / 2)
            img[m] = o["color"] * rng.uniform(0.95, 1.05)
            for prev in frame_ms:
                prev &= ~m
            frame_ms.append(m)
        if occluder:
            ocx = w * (-0.2 + 1.4 * t / max(T - 1, 1))
            om = (((xx - ocx) / occ["rx"]) ** 2 + ((yy - occ["cy"]) / occ["ry"]) ** 2) < 1.0
            img[om] = occ["shade"] * rng.uniform(0.9, 1.1)
            for m in frame_ms:
                m &= ~om
        for k, m in enumerate(frame_ms):
            masks[t, k] = m.astype(np.float32)
        images[t] = np.clip(img, 0, 1)
    return images, masks


def _iou(pred_slot, gt):
    inter = (pred_slot & gt).sum()
    union = (pred_slot | gt).sum()
    return float(inter / union) if union else float("nan")


def protocol_clips(n_clips: int = 16, T: int = 32, h: int = 240, w: int = 432, seed: int = 7):
    """The protocol's clips: ``make_realistic_clip`` from ``default_rng(seed)``,
    every other clip with two objects, clips 2 and 3 of every four with an occluder."""
    rng = np.random.default_rng(seed)
    return [make_realistic_clip(rng, T, h, w, n_objects=2 if i % 2 else 1, occluder=i % 4 >= 2)
            for i in range(n_clips)]


def row_tracker(row: str, image_size: Tuple[int, int], device=None) -> TrackerCore:
    """The ``TrackerCore`` of a row of the table: 2 object slots, ring of 8 written
    every 4 frames, long-term memory off; fp32, or for "bench-exact" bf16 with
    ``affinity_bf16``, or for "int8 memory" the int8 ring."""
    kw = dict(image_size=image_size, max_objects=2, mem_frames=8, mem_every=4, enable_long_term=False)
    if row == "bench-exact":
        kw.update(dtype=torch.bfloat16, affinity_bf16=True)
    elif row == "int8 memory":
        kw.update(quantized_memory=True)
    return TrackerCore(variables=WEIGHTS, device=device, **kw)


@torch.no_grad()
def eval_config(core: TrackerCore, clips, window: int = 0, exact: bool = False) -> List[float]:
    """Propagate each clip from its frame-0 ground truth; returns the per-frame,
    per-object IoUs over frames 1..T-1 in the order the tool scores them."""
    ious: List[float] = []
    No, dev = core.max_objects, core.device

    def score_ids(ids_t, masks_t, K):
        for k in range(K):
            gt = masks_t[k] > 0.5
            if not gt.any():
                continue
            v = _iou(ids_t == (k + 1), gt)
            if not np.isnan(v):
                ious.append(v)

    for images, masks in clips:
        T, H, W = images.shape[:3]
        K = min(masks.shape[1], No)
        onehot0 = np.zeros((No, H, W), np.float32)
        obj_valid = np.zeros((No,), bool)
        for k in range(K):
            onehot0[k] = masks[0, k]
            obj_valid[k] = bool(masks[0, k].any())
        x = torch.from_numpy(images).to(dev).permute(0, 3, 1, 2).to(core.dtype)
        keys, skips = core.net.encode_key(x)

        def feats(t):
            return keys[t], {k: v[t] for k, v in skips.items()}

        mem = core.memory
        _, mem, _ = core._incorporate_from_feats(mem, *feats(0), torch.from_numpy(onehot0).to(dev),
                                                 torch.from_numpy(obj_valid).to(dev))
        t = 1
        while t < T:
            e = min(t + window, T) if window > 1 else t + 1
            if window > 1 and e - t == window:
                act = mem.active.float()
                mem, logits_s4 = core.propagate_frames(mem, keys[t:e], {k: v[t:e] for k, v in skips.items()},
                                                       window=window, exact=exact, return_logits=True)
                probs = soft_aggregate(upsample_bilinear_matmul(logits_s4, H, W), act)
                ids = probs.argmax(dim=1).cpu().numpy()
                for j in range(e - t):
                    score_ids(ids[j], masks[t + j], K)
            else:
                # per-frame step; with windows, the trailing partial window (a short
                # window would change the write cadence)
                for tt in range(t, e):
                    prob, mem = core._step_from_feats(mem, *feats(tt))
                    score_ids(prob.argmax(dim=0).cpu().numpy(), masks[tt], K)
            t = e
    return ious


def run_protocol(n_clips: int = 16, T: int = 32, h: int = 240, w: int = 432, device=None) -> Dict[str, Dict]:
    """Every row on the protocol's clips: {row: {"mean_iou", "n", "jax_mean_iou"}}."""
    clips = protocol_clips(n_clips, T, h, w)
    out = {}
    for row in JAX_MEAN_IOU:
        core = row_tracker(row, (h, w), device)
        kw = dict(window=4, exact=True) if row == "bench-exact" else {}
        ious = eval_config(core, clips, **kw)
        out[row] = {"mean_iou": float(np.mean(ious)) if ious else 0.0, "n": len(ious),
                    "jax_mean_iou": JAX_MEAN_IOU[row]}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clips", type=int, default=16)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=432)
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    res = run_protocol(args.clips, args.frames, args.height, args.width, args.device)
    print(json.dumps({"metric": "tracker propagation IoU (realistic holdout)", "rows": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
