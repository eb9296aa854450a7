#!/usr/bin/env python3
"""Device busy share and kernel time by name inside one ``YOLO.predict`` of the port.

    python3 scripts/profile_predict_torch.py [--batch 4] [--retina] [--out chiprun_out]

Runs ``chip_smoke.py``'s configuration (YOLOv10-S seg, seeded random init,
seeded 720×1280 frames, imgsz 640, conf 0.018) on the card: two warm-up calls,
then one call under ``torch.profiler``.  Prints one JSON object: the call's
wall time on the host clock, the summed device time of every kernel and copy
(one stream, so the sum is the busy time), the busy share, and the ten
kernels with the most device time.  The Chrome trace goes to ``--out``.
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
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_predict_torch: no CUDA device available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import seeded_frames
    from yolo_puncture_tpu_torch import YOLO

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    frames = list(seeded_frames(args.batch, 720, 1280, seed=0))
    det = YOLO("yolo10s-seg", nc=1, seed=0)
    kw = dict(conf=0.018, imgsz=640, retina_masks=args.retina)
    for _ in range(2):
        det.predict(frames, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        det.predict(frames, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies, sets): host ops also carry device totals
    by_name = sorted(((device_us(e), e.key, e.count) for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA") and device_us(e) > 0), reverse=True)
    busy_ms = sum(us for us, _, _ in by_name) / 1e3
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, f"predict_b{args.batch}{'_retina' if args.retina else ''}.json")
    prof.export_chrome_trace(trace)
    print(json.dumps({
        "card": smi, "batch": args.batch, "retina": args.retina, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "top_kernels": [{"name": k[:80], "ms": us / 1e3, "count": n} for us, k, n in by_name[:10]],
        "trace": os.path.relpath(trace, ROOT),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
