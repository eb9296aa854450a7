#!/usr/bin/env python3
"""Device busy share and kernel time by name inside one call of the port.

    python3 scripts/profile_predict_torch.py [--batch 4] [--retina] [--out chiprun_out]
    python3 scripts/profile_predict_torch.py --tracker [--out DIR]
    python3 scripts/profile_predict_torch.py --pipeline [--out DIR]
    python3 scripts/profile_predict_torch.py --bench [--batch 128] [--out DIR]
    python3 scripts/profile_predict_torch.py --train [--out DIR]

Without ``--tracker``: one ``YOLO.predict`` in ``chip_smoke.py``'s configuration
(YOLOv10-S seg, seeded random init, seeded 720×1280 frames, imgsz 640, conf
0.018).  With it: the mask tracker in ``chip_smoke.py``'s configuration
(``TrackerCore`` at 480×864, 4 objects, a ring of 8 frames written every 5, the
shipped needle checkpoint, a moving bright bar), two profiles: one 5-frame
window of ``step_batch`` and 5 ``step`` calls.  With ``--pipeline``: one
``VideoSpeedPipeline.process_frames`` in ``chip_smoke.py``'s phase 3d
configuration (67 needle frames of 720×1280, YOLOv10-S seg at 640²,
EfficientNet-B3 on 380² crops, ``device_batch=8``, seeded random weights, the
same ``conf``).  With ``--bench``: one fused step of
``python -m yolo_puncture_tpu_torch.bench`` (B 128 by default).  With
``--train``: one training step of the tracker's trainer in ``chip_smoke.py``'s
phase 3q configuration (``apps/train_tracker.py``'s defaults: 8 clips of 4
frames at 256², seeded init) and one of the detector's ``Trainer`` in phase 3r's
(YOLOv10-S seg at 640², B 8, a synthetic batch of polygons).  Each time two
warm-up calls,
then one call under ``torch.profiler``.  Prints one JSON object per profile:
the call's wall time on the host clock, the device's busy time (the union of
the intervals of every kernel, copy and fill over all streams,
``benchmark/tracefile.py union_length``), the busy share, and the ten kernels
with the most device time.  The Chrome traces go to ``--out``.
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
    ap.add_argument("--batch", type=int, default=None, help="frames a call: 4 for predict, 128 for the bench")
    ap.add_argument("--retina", action="store_true")
    ap.add_argument("--tracker", action="store_true")
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--train", action="store_true")
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

    if args.bench:
        return profile_bench(args.batch or 128, args.out, smi)

    if args.train:
        return profile_train(args.out, smi)

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

    batch = args.batch or 4
    frames = list(seeded_frames(batch, 720, 1280, seed=0))
    det = YOLO("yolo10s-seg", nc=1, seed=0)
    kw = dict(conf=0.018, imgsz=640, retina_masks=args.retina)
    for _ in range(2):
        det.predict(frames, **kw)
    profile_call(lambda: det.predict(frames, **kw), f"predict_b{batch}{'_retina' if args.retina else ''}",
                 args.out, smi, {"batch": batch, "retina": args.retina})
    return 0


def profile_bench(batch: int, out_dir: str, card: str) -> int:
    """One fused bench step under the profiler, after two chained ones."""
    from yolo_puncture_tpu_torch import bench as bm

    model, (mem, track_fn) = bm.bench_models(640, True)
    frames = torch.from_numpy(bm.seeded_frames(batch)).to("cuda")
    step = bm.make_fused_step(model, track_fn, 640)
    state = {"mem": mem, "chk": torch.zeros((), device="cuda")}

    def steps(n):
        for _ in range(n):
            out, state["mem"] = step(state["mem"], frames, bm.CONF, state["chk"])
            state["chk"] = out["chk"]
        return float(state["chk"])

    steps(2)
    profile_call(lambda: steps(1), f"bench_b{batch}", out_dir, card, {"batch": batch, "frames_hw": bm.FRAME_HW})
    return 0


def profile_train(out_dir: str, card: str) -> int:
    """One step of each trainer under the profiler, after two unprofiled ones."""
    from chip_smoke import DET_TRAIN_B, TRACKER_TRAIN_ARGS, polygon_batch
    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.apps import train_tracker
    from yolo_puncture_tpu_torch.train import Trainer

    args = train_tracker.parse_args(TRACKER_TRAIN_ARGS)
    _, trainer = train_tracker.build_trainer(args)
    batch = trainer._sample_batch()
    for _ in range(2):
        trainer.train_step(*batch)
    profile_call(lambda: trainer.train_step(*batch), "train_tracker_step", out_dir, card,
                 {"clips": args.batch, "clip_len": args.clip_len, "hw": [args.height, args.width],
                  "objects": args.max_objects})
    tr = Trainer(YOLO("yolo10s-seg", nc=1, seed=0).model, nc=1, imgsz=640)
    state = tr.init_state()
    det_batch = polygon_batch(DET_TRAIN_B, 640, seed=8)
    for _ in range(2):
        state, _ = tr.train_step(state, det_batch)
    profile_call(lambda: tr.train_step(state, det_batch), "train_detector_step", out_dir, card,
                 {"model": "yolo10s-seg", "imgsz": 640, "batch": DET_TRAIN_B})
    return 0


def profile_call(fn, label: str, out_dir: str, card: str, extra: dict) -> None:
    """``fn()`` once under the profiler; one JSON line and a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.tracefile import Trace, union_length

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
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, f"{label}.json")
    prof.export_chrome_trace(trace)
    busy_ms = union_length((d["start"], d["end"]) for d in Trace.load(trace).device) / 1e3
    print(json.dumps({
        "card": card, **extra, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "device_events": sum(n for _, _, n in by_name),
        "top_kernels": [{"name": k[:80], "ms": us / 1e3, "count": n} for us, k, n in by_name[:10]],
        "trace": os.path.relpath(trace, ROOT),
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
