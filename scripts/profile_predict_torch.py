#!/usr/bin/env python3
"""Device busy share and kernel time by name inside one call of the port.

    python3 scripts/profile_predict_torch.py [--batch 4] [--retina] [--out chiprun_out]
    python3 scripts/profile_predict_torch.py --tracker [--out DIR]
    python3 scripts/profile_predict_torch.py --pipeline [--out DIR]

Without ``--tracker``: one ``YOLO.predict`` in ``chip_smoke.py``'s configuration
(YOLOv10-S seg, seeded random init, seeded 720×1280 frames, imgsz 640, conf
0.018).  With it: the mask tracker in ``chip_smoke.py``'s configuration
(``TrackerCore`` at 480×864, 4 objects, a ring of 8 frames written every 5, the
shipped needle checkpoint, a moving bright bar), two profiles: one 5-frame
window of ``step_batch`` and 5 ``step`` calls.  With ``--pipeline``: one
``VideoSpeedPipeline.process_frames`` in ``chip_smoke.py``'s phase 3d
configuration (67 needle frames of 720×1280, YOLOv10-S seg at 640²,
EfficientNet-B3 on 380² crops, ``device_batch=8``, seeded random weights, the
same ``conf``).  Each time two warm-up calls,
then one call under ``torch.profiler``.  Prints one JSON object per profile:
the call's wall time on the host clock, the summed device time of every kernel
and copy (one stream, so the sum is the busy time), the busy share, and the ten
kernels with the most device time.  The Chrome traces go to ``--out``.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--retina", action="store_true")
    ap.add_argument("--tracker", action="store_true")
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_predict_torch: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()

    if args.tracker:
        from chip_smoke import NEEDLE, TRACK_GEOMETRY, bar_frames, drive_tracker
        from yolo_puncture_tpu_torch.track import TrackerCore

        frames, masks = bar_frames(19, 720, 1280, seed=1)
        core = TrackerCore(enable_long_term=False, variables=NEEDLE, **TRACK_GEOMETRY)
        drive_tracker(core, frames, masks)              # fills the ring to 5 of 8 slots and builds the kernels
        window = list(frames[6:11])
        for label, fn in (("tracker_window", lambda: core.step_batch(window)),
                          ("tracker_steps", lambda: [core.step(f) for f in window])):
            for _ in range(2):
                fn()
            profile_call(fn, label, args.out, smi, {"call": label, "frames": len(window), **TRACK_GEOMETRY,
                                                    "ring_slots_valid": int(core.memory.valid.sum())})
        return 0

    if args.pipeline:
        from chip_smoke import PIPE_FRAMES, PIPE_KEY_FRAME, needle_clip, pipeline_conf
        from yolo_puncture_tpu_torch import YOLO
        from yolo_puncture_tpu_torch.pipeline import VideoSpeedPipeline
        from yolo_puncture_tpu_torch.tasks import ClassifierNet

        clip, _, _ = needle_clip(PIPE_FRAMES, 720, 1280, PIPE_KEY_FRAME, seed=2)
        pipe = VideoSpeedPipeline(YOLO("yolo10s-seg", nc=1, seed=0), ClassifierNet("efficientnet_b3", seed=0),
                                  device_batch=8, imgsz=640, crop_size=380)
        conf, _ = pipeline_conf(pipe, clip)
        for _ in range(2):
            pipe.process_frames(list(clip), fps=30.0, conf=conf)
        profile_call(lambda: pipe.process_frames(list(clip), fps=30.0, conf=conf), "pipeline", args.out, smi,
                     {"frames": PIPE_FRAMES, "device_batch": 8, "conf": conf})
        return 0

    from chip_smoke import seeded_frames
    from yolo_puncture_tpu_torch import YOLO

    frames = list(seeded_frames(args.batch, 720, 1280, seed=0))
    det = YOLO("yolo10s-seg", nc=1, seed=0)
    kw = dict(conf=0.018, imgsz=640, retina_masks=args.retina)
    for _ in range(2):
        det.predict(frames, **kw)
    profile_call(lambda: det.predict(frames, **kw), f"predict_b{args.batch}{'_retina' if args.retina else ''}",
                 args.out, smi, {"batch": args.batch, "retina": args.retina})
    return 0


def profile_call(fn, label: str, out_dir: str, card: str, extra: dict) -> None:
    """``fn()`` once under the profiler; one JSON line and a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies, sets): host ops also carry device totals
    by_name = sorted(((device_us(e), e.key, e.count) for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA") and device_us(e) > 0), reverse=True)
    busy_ms = sum(us for us, _, _ in by_name) / 1e3
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, f"{label}.json")
    prof.export_chrome_trace(trace)
    print(json.dumps({
        "card": card, **extra, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "top_kernels": [{"name": k[:80], "ms": us / 1e3, "count": n} for us, k, n in by_name[:10]],
        "trace": os.path.relpath(trace, ROOT),
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
