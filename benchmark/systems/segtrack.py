"""The system of the seg+track cells: the port's fused seg+track step, built
from a configuration, driven by ``run.py`` through the seam that
``systems/__init__.py`` describes.

The benchmark takes from the program only what a user of it would: the models'
classes, ``track.build_bench_tracker`` and ``bench.make_fused_step``.  The
weights are the benchmark's (``weights.py``), loaded by name.  The detector and
the tracker are handed to ``make_fused_step`` wrapped in ``record_function``
ranges (``bench::detector``, ``bench::tracker``), the spans the per-layer
readers look for in the trace; the wrappers add no synchronisation.

Set-up draws the frames (``traffic.py``) and the weights from the seed on the
card and builds the step with them.  A step uploads its batch from pinned
memory, runs the program's step, and copies its outputs (best box, score, valid
flag, best-slot mask, id map) into pinned host memory; the tracker's memory and
the checksum are the state carried from step to step.  The check frees the
program, then the plain reference (``reference/``, fp32) recomputes each
checked step in blocks of ``REF_BLOCK`` frames from the same frames, weights
and memory, and ``check.py`` compares; the reference's detector also runs on
the witness's frames (``check.witness_frames``), whose gaps the detector's are
held against.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch
from torch.autograd.profiler import record_function

from benchmark import check as compare, reckon, traffic as traffic_mod, weights
from benchmark.reference import tracker as rt
from benchmark.reference import yolo as ry

DETECTOR_SPAN, TRACKER_SPAN = "bench::detector", "bench::tracker"
REF_BLOCK = 16


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


def reference_best_slot(model, frames_u8: torch.Tensor, cfg: Dict, tr: Dict) -> Dict[str, torch.Tensor]:
    """The reference detector's outputs in the program's form: the best slot's
    box, score, valid flag and mask, zeroed where it is not valid."""
    det = ry.detect(model, frames_u8, cfg["detector"]["imgsz"], tr["conf"], tr["max_det"], mask_slots=1)
    v = det["valid"][:, 0]
    return {"boxes": det["boxes"][:, 0] * v[:, None], "scores": det["scores"][:, 0] * v, "valid": v,
            "mask": (det["masks"][:, 0] & v[:, None, None]).to(torch.uint8)}


def host_outputs(cfg: Dict, B: int, pinned: bool) -> Dict[str, torch.Tensor]:
    """Host buffers for one step's outputs: the best slot's box, score, valid
    flag and mask (letterbox resolution), and the id map (tracker resolution)."""
    size, (h, w) = cfg["detector"]["imgsz"], reckon.tracker_hw(cfg)
    shapes = {"boxes": ((B, 4), torch.float32), "scores": ((B,), torch.float32), "valid": ((B,), torch.bool),
              "mask": ((B, size, size), torch.uint8), "ids": ((B, h, w), torch.uint8)}
    return {k: torch.empty(shape, dtype=dt, pin_memory=pinned) for k, (shape, dt) in shapes.items()}


class SegTrack:
    """One run's fused seg+track step: its frames, the reference's weights, the
    program built with them.  The state is (tracker memory, checksum)."""

    names = compare.NAMES

    def __init__(self, cell: Dict, seed: int, device, mark, fault=None):
        cfg, tr = self.cfg, self.tr = cell["cfg"], cell["tr"]
        dev = self.dev = torch.device(device)
        served = getattr(torch, cfg["dtype"])
        self.frames = traffic_mod.frames(tr, seed, dev)
        mark("frames")
        self.ref_det = weights.detector(cfg, seed, self.frames[0][:16], dev, served)
        self.ref_net = weights.tracker(cfg, seed, self.frames[0], dev, served)
        mark("weights")
        step, self.mem0 = build(cfg, tr, weights.served_state(self.ref_det, served),
                                weights.served_state(self.ref_net, served), dev)
        mark("program")
        self.step = step if fault is None else fault(step)
        self.seed = seed

    def initial(self):
        return self.mem0, torch.zeros((), device=self.dev)

    def outputs(self) -> Dict[str, torch.Tensor]:
        return host_outputs(self.cfg, self.tr["batch"], self.dev.type == "cuda")

    def hand(self, i: int, state, into: Dict[str, torch.Tensor]):
        mem, chk = state
        t_hand = time.perf_counter()
        batch = self.frames[i % self.tr["distinct_batches"]].to(self.dev, non_blocking=True)
        out, mem = self.step(mem, batch, self.tr["conf"], chk)
        t_ret = time.perf_counter()
        for k, buf in into.items():
            buf.copy_(out[k], non_blocking=True)
        rec = {"hand": t_hand, "ret": t_ret, "frames": self.tr["batch"]}
        if self.dev.type == "cuda":
            rec["event"] = torch.cuda.Event()
            rec["event"].record()
        else:                                    # the copies were synchronous
            rec["done"] = time.perf_counter()
        return rec, (mem, out["chk"])

    def check(self, checked: List[Dict]) -> Dict[str, float]:
        del self.step, self.mem0                 # the program freed before the reference runs
        cfg, tr, dev = self.cfg, self.tr, self.dev
        t = cfg["tracker"]
        hw = reckon.tracker_hw(cfg)
        lt_cap = t["max_long_term_elements"] if tr["long_term"] else 8
        ref_trk = rt.Tracker(self.ref_net, hw, t["window"], tr["long_term"], t["num_prototypes"],
                             t["full_res_ids"])
        frames_read, witness_read, ids_read, gaps = [], [], [], []
        size = cfg["detector"]["imgsz"]
        for c in checked:
            f = self.frames[c["i"] % tr["distinct_batches"]].to(dev)
            fw = compare.witness_frames(f, self.seed)
            for a in range(0, tr["batch"], REF_BLOCK):
                head = ry.head_outputs(self.ref_det, f[a:a + REF_BLOCK], size)
                prog = {k: v[a:a + REF_BLOCK] for k, v in c["out"].items()}
                frames_read.append(compare.per_frame(prog, head, tr["conf"], self.ref_det.num, size))
                wit = reference_best_slot(self.ref_det, fw[a:a + REF_BLOCK], cfg, tr)
                witness_read.append(compare.per_frame(wit, head, tr["conf"], self.ref_det.num, size))
                del head, wit
            st = (rt.initial_state(hw[0] // 16, hw[1] // 16, t["max_objects"], t["mem_frames"], lt_cap, dev)
                  if c["i"] == 0 else rt.state_from(c["pre"][0], dev))
            st_after, ids = ref_trk.step(st, f)
            ids_read.append(compare.ids_readings(c["out"]["ids"], ids))
            gaps.append(rt.state_gap(st_after, rt.state_from(c["post"][0], dev)))
        numbers = compare.combine(frames_read, ids_read, gaps)
        return {**numbers, **compare.witness_ratios(numbers, compare.frame_numbers(witness_read))}

    def step_flops(self) -> int:
        return reckon.step_flops(self.cfg, self.tr)


def setup(cell: Dict, seed: int, device, mark, fault=None) -> SegTrack:
    return SegTrack(cell, seed, device, mark, fault)
