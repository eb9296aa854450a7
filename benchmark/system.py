"""The system under test: the port's fused seg+track step, built from a configuration.

The benchmark takes from the program only what a user of it would: the models'
classes, ``track.build_bench_tracker`` and ``bench.make_fused_step``.  The
weights are the benchmark's (``weights.py``), loaded by name.  The detector and
the tracker are handed to ``make_fused_step`` wrapped in ``record_function``
ranges (``bench::detector``, ``bench::tracker``), the spans the per-layer
readers look for in the trace; the wrappers add no synchronisation.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.autograd.profiler import record_function

DETECTOR_SPAN, TRACKER_SPAN = "bench::detector", "bench::tracker"


def build(cfg: Dict, traffic: Dict, det_state: Dict, trk_state: Dict, device):
    """(step, initial memory): the program's fused step over the configuration's
    models with the benchmark's weights.  ``step(memory, frames_u8, conf, chk) →
    (outputs, memory)`` as ``bench.make_fused_step`` returns it."""
    from yolo_puncture_tpu_torch import _build
    from yolo_puncture_tpu_torch.bench import make_fused_step
    from yolo_puncture_tpu_torch.models.yolo import YOLOModel
    from yolo_puncture_tpu_torch.track import build_bench_tracker

    d, t = cfg["detector"], cfg["tracker"]
    dtype = getattr(torch, cfg["dtype"])
    if torch.device(device).type == "cuda":
        _build.build_all()              # every kernel source at once, where the checkout has no library yet
    with torch.device(device):
        model = YOLOModel(d["version"], d["scale"], nc=d["nc"], task=d["task"], dtype=dtype)
    model.load_state_dict(det_state)
    model.to(device).eval()
    mem0, track_fn = build_bench_tracker(
        d["imgsz"], dtype=dtype, min_side=t["min_side"], window=t["window"], frame_hw=tuple(t["frame_hw"]),
        device=device, max_objects=t["max_objects"], full_res_ids=t["full_res_ids"],
        affinity_bf16=t["affinity_bf16"], enable_long_term=traffic["long_term"])
    core = track_fn.core
    if (core.mem_every, core.memory.keys.shape[0]) != (t["window"], t["mem_frames"]):
        raise ValueError(f"the program's tracker writes every {core.mem_every} frames into a ring of "
                         f"{core.memory.keys.shape[0]}; the configuration says {t['window']} and {t['mem_frames']}")
    core.net.load_state_dict(trk_state)

    def detector(imgs):
        with record_function(DETECTOR_SPAN):
            return model(imgs)

    def tracker(memory, frames_u8, pyramid=None):
        with record_function(TRACKER_SPAN):
            return track_fn(memory, frames_u8, pyramid)

    return make_fused_step(detector, tracker, d["imgsz"]), mem0
