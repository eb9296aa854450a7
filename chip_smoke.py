#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``yolo_puncture_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):
  1. build every CUDA kernel from ``yolo_puncture_tpu_torch/csrc`` (one nvcc per
     source, in parallel) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card:
     ``proto_decode`` (soft and binary, pixel counts that leave the 4-pixel
     vectors and the blocks ragged, 1 to 70 instances, box edges on vector
     boundaries), ``memory_readout`` (fp32 and bf16, ragged shapes, odd
     object counts, the memory split over blocks, a softmax spread over the
     memory and one carried by a few elements; fp32 also against a float64
     readout on large logits) and ``decode_tail`` (fp32 and bf16, the window,
     one frame and shapes down to a single pixel);
  3. drive the main paths with every kernel's launch count set to 0 just before
     and read just after, each kernel of a path must have run:
     ``YOLO("yolo10s-seg").predict`` at imgsz 640 on four seeded 720×1280 frames
     (non-retina, then retina), and the mask tracker ``TrackerCore`` at 480×864
     with the shipped needle checkpoint on seeded 720×1280 frames of a moving
     bright bar (``incorporate_detection``, 5× ``step``, ``step_batch`` of 12
     frames, a second ``incorporate_detection``), then the same tracker in bf16
     (``incorporate_detection``, 5× ``step``, one window), held against the fp32
     run on the card; then the speed pipeline ``VideoSpeedPipeline`` (YOLOv10-S
     seg at 640², EfficientNet-B3 on 380² crops, ``device_batch=8``) over 67
     seeded 720×1280 frames of a needle whose visible length shrinks after a key
     frame, ``conf`` between two of the clip's best scores so that some frames
     are detected and some not (``proto_decode`` once per batch), and two clips
     through the interleaved batches of ``process_videos``, each against its own
     run;
  4. run the same calls on the CPU (one frame of predict; the tracker up to its
     first window; one batch of the pipeline's device step) and compare;
  5. run the tracker with long-term memory on for 7 frames, once with the
     constructor's defaults and once with a ring of two slots so that
     consolidation fires: this readout returns the attention usage and is plain
     PyTorch, so ``memory_readout``'s count must not move;
  6. time each kernel, its plain version and a PyTorch yardstick with CUDA
     events, and ``predict``, one ``step``, one window and the pipeline's
     ``process_frames`` over the clip (frames per second, its stages) with a
     synchronised host clock.

The line before the last is a JSON object ``{"kernels": [...]}`` with each
kernel's launches on its main path, its error against the plain version, its
times and its bound; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the package beside it, the script exits
non-zero before printing any result.  The detector's weights are a seeded
random init; the tracker's are ``resources/weights/tracker_propagation_needle.msgpack``;
the classifier's are a seeded random init too.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12    # outside the tensor cores
TF32_FLOP_PER_S = 495e12   # tensor cores
BF16_FLOP_PER_S = 989e12   # tensor cores

SOFT_ATOL = 1e-6   # soft masks: kernel vs plain version (fp32 sums in another order)
THRESH_BAND = 1e-6  # binary masks may differ only where the soft value is this close to the threshold
# memory_readout and decode_tail against their plain versions, fp32: sums of up to
# 13 k (readout) and 1152 (tail) fp32 terms taken in another order
FP32_TOL = 2e-4
# bf16 readout, held element by element.  Both sides round p to bf16 before it meets the
# values, but the kernel rounds exp(s - running max) and rescales later while the plain
# version rounds exp(s - final max), so each p may round the other way on each side: a
# relative 2^-8 (half an ulp of 8 significant bits) twice, at most 2^-7 * sum(p |v|) / l
# in the output.  Where many elements carry a row the roundings are independent and
# cancel: their sum has a deviation of 2^-8 * sqrt(2/3) * sqrt(sum(p^2 v^2)) / l, and
# 2^-5 of that root is ten deviations.  The limit takes the smaller of the two, from the
# plain version's own p, so it is a few 1e-4 where a softmax over thousands of elements
# gives outputs of a few 1e-2, and about 1e-2 where a few elements give outputs near 1.
# On top, both round the result to bf16: one ulp (2^-7 relative, no clamp) where the two
# fp32 values straddle a rounding edge.  The floor covers fp32 sums in another order.
READOUT_BF16_ULP = 2.0 ** -7
READOUT_BF16_P_WORST = 2.0 ** -7
READOUT_BF16_P_SPREAD = 2.0 ** -5
READOUT_BF16_FLOOR = 2e-5
# fp32 readout against a float64 readout on logits of 30 to 80: three error-compensated
# TF32 products are fp32-class, one TF32 product is a hundred times off
# (tests/test_torch_memory_readout.py shows both in a plain emulation).  An fp32 logit of
# 70 is itself rounded by 4e-6, which the exponential passes on, so at the large shapes
# no fp32 readout stays within 2e-6: the kernel may be twice as far from float64 as the
# plain fp32 version is on the same inputs (1e-5 at the window), plus this
READOUT_FP64_TOL = 2e-6
# the bf16 tracker against the fp32 tracker, both on the card: the limits of the CPU
# test of the same pair (tests/test_torch_track_core.py)
TRACK_BF16_PROB_TOL = 0.1
TRACK_BF16_ID_AGREE = 0.99
# bf16 tail: an activation rounded the other way (one ulp, 2^-8 relative) moves a
# logit by about 1e-3, and a few hundred of them meet in one logit
TAIL_BF16_TOL = 5e-2
# the tracker on the card against its CPU run: probabilities after 11 recurrent
# frames through cuDNN's and the CPU's convolutions
TRACK_PROB_TOL = 5e-3
TRACK_ID_AGREE = 0.999

# the speed pipeline's clip: 8 full batches of 8 and a ragged one
PIPE_FRAMES, PIPE_KEY_FRAME = 67, 24

ROOT = os.path.dirname(os.path.abspath(__file__))
NEEDLE = os.path.join(ROOT, "resources", "weights", "tracker_propagation_needle.msgpack")
TRACK_GEOMETRY = dict(image_size=(480, 864), max_objects=4, mem_frames=8, mem_every=5)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn()`` over back-to-back launches (L2-warm), CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(make, launches: int = 20, replays: int = 10) -> float:
    """Mean device time of ``fn = make()`` replayed from a CUDA graph of ``launches``
    calls: no host launch cost and no gap between kernels, which at 10 us a kernel
    are a third of what back-to-back launches from Python measure.  ``make`` is
    called on the capturing stream, so a raw launch binds that stream."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn = make()
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(launches):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(replays):
            graph.replay()
        end.record(stream)
        torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def predict_stage_ms(det, frames, **kw) -> dict:
    """One ``det.predict(frames, **kw)`` with the predictor's stages timed on the
    host clock, the device synchronised before and after each stage (so the
    stages do not overlap as they do in an unclocked call).  'host' is the rest:
    frame stacking, the copies to and from the card, and building the Results."""
    from yolo_puncture_tpu_torch.predict import predictor as pp

    ms = dict.fromkeys(("letterbox", "model", "select", "decode", "paste"), 0.0)

    def clocked(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            ms[name] += (time.perf_counter() - t) * 1e3
            return out
        return run

    patched = {"letterbox": "letterbox", "select_detections": "select", "decode_masks": "decode"}
    saved = {attr: getattr(pp, attr) for attr in patched}
    model = det.model
    try:
        for attr, stage in patched.items():
            setattr(pp, attr, clocked(stage, saved[attr]))
        det.model = clocked("model", model)
        det._paste = clocked("paste", det._paste)  # resample, retina crop and threshold
        torch.cuda.synchronize()
        t = time.perf_counter()
        det.predict(frames, **kw)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
    finally:
        for attr, fn in saved.items():
            setattr(pp, attr, fn)
        det.model = model
        del det._paste
    ms["host"] = total - sum(ms.values())
    ms["total"] = total
    return ms


def proto_decode_inputs(B, N, Hp, Wp, nm, seed, device, snap=0):
    """Seeded protos (B, nm, Hp, Wp), coeffs (B, N, nm) and boxes (B, N, 4).  Every
    fourth box has integer edges (the half-open test); ``snap`` > 0 puts every
    edge on a multiple of it, the boundaries of the kernel's pixel vectors."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((B, nm, Hp, Wp)).astype(np.float32)
    coeffs = (0.5 * rng.standard_normal((B, N, nm))).astype(np.float32)
    x1 = rng.uniform(-5, Wp * 0.6, (B, N))
    y1 = rng.uniform(-5, Hp * 0.6, (B, N))
    boxes = np.stack([x1, y1, x1 + rng.uniform(1, Wp, (B, N)), y1 + rng.uniform(1, Hp, (B, N))], -1)
    boxes[:, ::4] = np.round(boxes[:, ::4])  # integer edges exercise the half-open test
    if snap:
        boxes = np.round(boxes / snap) * snap
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)  # noqa: E731
    return to(protos), to(coeffs), to(boxes)


# (B, N, Hp, Wp, threshold, crop, box edges snapped to multiples of)
PROTO_CASES = [
    (4, 32, 160, 160, None, True, 0),     # the detector's shape
    (4, 32, 160, 160, 0.5, True, 0),
    (4, 32, 160, 160, None, False, 0),
    (4, 32, 160, 160, 0.5, False, 0),
    (4, 70, 160, 160, None, True, 0),     # unsplit: three shared-memory chunks of instances, the last ragged
    (1, 32, 160, 160, None, True, 4),     # one frame: the instances split over blocks; edges on vector boundaries
    (1, 32, 160, 160, 0.3, True, 4),      # a threshold whose logit is not 0
    (3, 37, 100, 168, None, True, 0),
    (3, 37, 100, 168, 0.5, True, 0),
    (2, 1, 96, 168, None, True, 0),       # a non-square imgsz, one instance
    (2, 33, 96, 168, 0.5, True, 4),       # an odd count shared out over two blocks
    (2, 65, 96, 168, None, True, 0),
    (2, 65, 96, 168, 0.7, False, 0),
    (2, 70, 33, 45, None, True, 0),       # P = 1485 is odd: element-wise loads and stores, a ragged last vector
    (2, 70, 33, 45, 0.5, True, 0),
    (3, 9, 25, 30, None, True, 0),        # P = 750 = 4 * 187 + 2
    (3, 9, 25, 30, 0.5, False, 0),
    (2, 5, 16, 20, 0.0, True, 0),         # thresholds outside (0, 1) keep the sigmoid
    (2, 5, 16, 20, 1.0, False, 0),
    (8, 1, 160, 160, None, False, 0),     # the speed pipeline's launch: the best slot of 8 frames, soft, no crop
]


def check_proto_decode_case(case, device, seed=100) -> float:
    """One case of PROTO_CASES on the card, kernel against plain version: soft masks
    within SOFT_ATOL, binary masks equal outside THRESH_BAND around the threshold.
    Raises where they disagree; returns the largest soft difference (0 for binary)."""
    from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode, proto_decode_reference

    B, N, Hp, Wp, thr, crop, snap = case
    protos, coeffs, boxes = proto_decode_inputs(B, N, Hp, Wp, 32, seed, device, snap)
    got = proto_decode(protos, coeffs, boxes, thr, crop)
    ref = proto_decode_reference(protos, coeffs, boxes, thr, crop)
    torch.cuda.synchronize()
    if got.dtype != torch.float32 or tuple(got.shape) != (B, N, Hp, Wp):
        raise AssertionError(f"proto_decode gave {got.dtype} {tuple(got.shape)}")
    if thr is None:
        err = float((got - ref).abs().max())
        log(f"proto_decode B={B} N={N} {Hp}x{Wp} soft crop={crop}: max abs diff {err:.3g}")
        if not err <= SOFT_ATOL:
            raise AssertionError(f"soft masks differ by {err} > {SOFT_ATOL}")
        return err
    soft = proto_decode_reference(protos, coeffs, boxes, None, crop)
    bad = (got != ref) & ((soft - thr).abs() > THRESH_BAND)
    n_diff, n_bad = int((got != ref).sum()), int(bad.sum())
    log(f"proto_decode B={B} N={N} {Hp}x{Wp} thr={thr} crop={crop}: "
        f"{n_diff} binary pixels differ, {n_bad} outside the ±{THRESH_BAND} band")
    if n_bad or not set(torch.unique(got).tolist()) <= {0.0, 1.0}:
        raise AssertionError(f"{n_bad} binary pixels differ away from the threshold")
    return 0.0


def check_proto_decode(device) -> float:
    """Kernel vs plain version on the card; returns the largest soft difference."""
    return max(check_proto_decode_case(case, device, 100 + i) for i, case in enumerate(PROTO_CASES))


def seeded_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """BGR uint8 frames: smooth gradients and a few bright bars over noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = rng.integers(0, 40, (n, h, w, 3)).astype(np.int32)
    for i in range(n):
        frames[i] += ((xx * (i + 1) + yy) % 200)[..., None]
        for _ in range(3):
            x0, y0 = rng.integers(0, w - 200), rng.integers(0, h - 60)
            frames[i, y0:y0 + rng.integers(8, 60), x0:x0 + rng.integers(60, 200)] = 230
    return np.clip(frames, 0, 255).astype(np.uint8)


def check_results(results, n_frames, h, w):
    if len(results) != n_frames:
        raise AssertionError(f"{len(results)} results for {n_frames} frames")
    total_mask_px = 0
    for r in results:
        n = len(r.boxes)
        xyxy = r.boxes.xyxy
        if not (np.isfinite(xyxy).all() and np.isfinite(r.boxes.conf).all()):
            raise AssertionError("non-finite boxes or scores")
        if n and not ((xyxy >= 0).all() and (xyxy[:, [0, 2]] <= w).all() and (xyxy[:, [1, 3]] <= h).all()):
            raise AssertionError("boxes outside the frame")
        if r.masks is None or r.masks.data.shape != (n, h, w):
            raise AssertionError(f"masks shape {None if r.masks is None else r.masks.data.shape}, want {(n, h, w)}")
        if not set(np.unique(r.masks.data)).issubset({0.0, 1.0}):
            raise AssertionError("masks are not binary")
        total_mask_px += int(r.masks.data.sum())
    counts = [len(r) for r in results]
    if sum(counts) == 0 or total_mask_px == 0:
        raise AssertionError(f"no detections or empty masks: counts {counts}, mask pixels {total_mask_px}")
    return counts, total_mask_px


def compare_to_cpu(gpu_r, cpu_r) -> dict:
    """Match each GPU detection to the CPU detection with the nearest box and score."""
    if len(gpu_r) != len(cpu_r):
        raise AssertionError(f"GPU found {len(gpu_r)} detections, CPU {len(cpu_r)}")
    gb, cb = gpu_r.boxes, cpu_r.boxes
    box_err, score_err, mask_agree = 0.0, 0.0, 1.0
    for i in range(len(gb)):
        d = np.abs(cb.xyxy - gb.xyxy[i]).max(axis=1) + 1e3 * np.abs(cb.conf - gb.conf[i])
        j = int(np.argmin(d))
        box_err = max(box_err, float(np.abs(cb.xyxy[j] - gb.xyxy[i]).max()))
        score_err = max(score_err, float(abs(cb.conf[j] - gb.conf[i])))
        if cb.cls[j] != gb.cls[i]:
            raise AssertionError("class differs between GPU and CPU")
        mask_agree = min(mask_agree, float((cpu_r.masks.data[j] == gpu_r.masks.data[i]).mean()))
    out = {"n": len(gb), "box_max_abs": box_err, "score_max_abs": score_err,
           "mask_min_agreement": mask_agree}
    if not (box_err <= 0.05 and score_err <= 1e-4 and mask_agree >= 0.999):
        raise AssertionError(f"GPU and CPU predictions disagree: {out}")
    return out


def readout_inputs(Q, M, No, Cv, dtype, seed, device, valid="all", scale=1.0, match=False):
    """Seeded query, keys, values and validity for the memory readout.  ``valid``:
    'all', 'none', 'random' (half), 'last' (only the last three elements, so
    that the first valid element lies in the last tile), or 'slots' (every other
    run of 1620 elements, a ring slot at 480×864, so that tiles straddle an edge).
    ``scale`` multiplies query and keys: at 1 a row's softmax spreads over
    thousands of elements, at 2 the logits have a deviation of 4 and a few
    elements anywhere in the memory carry each row.  ``match`` adds 1.2 × query
    row i to key i and makes it valid, so that with ``scale`` 2 every row has one
    logit of 30 and more."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, 64)).astype(np.float32) * np.float32(scale)
    k = rng.standard_normal((M, 64)).astype(np.float32) * np.float32(scale)
    v = rng.standard_normal((No, M, Cv)).astype(np.float32)
    mask = {"all": np.ones(M, bool), "none": np.zeros(M, bool), "random": rng.random(M) < 0.5,
            "last": np.arange(M) >= M - 3, "slots": (np.arange(M) // 1620) % 2 == 0}[valid]
    if match:
        n = min(Q, M)
        k[:n] += np.float32(1.2) * q[:n]
        mask[:n] = True
    to = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)  # noqa: E731
    return to(q), to(k), to(v), torch.from_numpy(mask).to(device)


def softmax_weights(q, k, ok, dtype):
    """Plain masked softmax of the readout in ``dtype``: the unnormalised weights
    p (Q, M), exp of the logit less the row's max, and their floored sum l (Q, 1)."""
    s = torch.matmul(q.to(dtype), k.to(dtype).T) * q.shape[-1] ** -0.5
    s = s.masked_fill(~ok[None, :], float("-inf"))
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m))) * ok[None, :]
    return p, p.sum(dim=-1, keepdim=True).clamp_min(1e-9)


def readout_bf16_limit(q, k, v, ok, ref):
    """Largest difference allowed at each element of a bf16 readout against its
    plain version ``ref`` (see READOUT_BF16_ULP and the lines above it)."""
    p, l = softmax_weights(q, k, ok, torch.float32)
    vf = v.float()
    worst = READOUT_BF16_P_WORST * torch.matmul(p, vf.abs())
    spread = READOUT_BF16_P_SPREAD * torch.matmul(p * p, vf * vf).sqrt()
    return READOUT_BF16_ULP * ref.float().abs() + torch.minimum(worst, spread) / l[None] + READOUT_BF16_FLOOR


# (Q, M, No, valid, forced number of memory splits or None for the wrapper's choice)
READOUT_CASES = [
    (8100, 12968, 4, "all", None),       # the window
    (8100, 12968, 4, "random", None),
    (1620, 12968, 4, "all", None),       # one frame: the wrapper splits the memory
    (52, 300, 3, "random", None),        # ragged, an odd object count
    (100, 333, 2, "none", None),         # no valid element: exact zeros
    (1620, 12968, 4, "last", None),      # the first valid element in the last tile
    (100, 300, 1, "random", None),       # half an object pair
    (100, 300, 5, "random", None),       # two pairs and a half
    (1, 300, 2, "random", None),
    (65, 300, 2, "random", None),        # one row into the second warpgroup
    (52, 63, 2, "all", None),
    (52, 65, 2, "all", None),            # one element into the second tile
    (1620, 12968, 4, "slots", None),     # tiles that straddle a slot edge
    (52, 300, 3, "random", 3),           # the split forced at a small shape
    (65, 333, 5, "last", 3),             # two of three splits with no valid element
    (8100, 12968, 4, "slots", 2),
]
# the same tuples, for the fp32 kernel against a float64 readout on matched inputs
READOUT_FP64_CASES = [(96, 640, 2, "random", None), (96, 640, 2, "random", 3),
                      (1620, 12968, 4, "random", None), (8100, 12968, 4, "slots", None)]


def launch_readout(q, k, v, ok, n_split=None):
    """``memory_readout`` with the wrapper's own choice of memory splits or with
    ``n_split`` forced; returns (readout, splits used)."""
    from yolo_puncture_tpu_torch.ops.kernels import memory_readout as mr

    chosen = mr.split_for
    try:
        if n_split is not None:
            mr.split_for = lambda *a: n_split
        return mr.memory_readout(q, k, v, ok), mr.split_for(q.shape[0], k.shape[0], q.device)
    finally:
        mr.split_for = chosen


def check_readout_case(case, dtype, scale, device, seed=200) -> float:
    """One case of READOUT_CASES on the card, kernel against plain version: fp32
    within FP32_TOL, bf16 within ``readout_bf16_limit`` at every element.  Raises
    where they disagree; returns the largest absolute difference."""
    from yolo_puncture_tpu_torch.ops.kernels.memory_readout import memory_readout_reference

    Q, M, No, valid, n_split = case
    q, k, v, ok = readout_inputs(Q, M, No, 128, dtype, seed, device, valid, scale)
    got, used = launch_readout(q, k, v, ok, n_split)
    ref = memory_readout_reference(q, k, v, ok)
    torch.cuda.synchronize()
    if got.dtype != dtype or tuple(got.shape) != (No, Q, 128) or not torch.isfinite(got).all():
        raise AssertionError(f"memory_readout gave {got.dtype} {tuple(got.shape)}, finite: "
                             f"{bool(torch.isfinite(got).all())}")
    if valid == "none" and float(got.float().abs().max()) != 0.0:
        raise AssertionError("rows with no valid element must read exact zeros")
    diff = (got.float() - ref.float()).abs()
    limit = torch.full_like(diff, FP32_TOL) if dtype == torch.float32 else readout_bf16_limit(q, k, v, ok, ref)
    at = int((diff / limit).argmax())
    log(f"memory_readout Q={Q} M={M} No={No} valid={valid} scale={scale:g} splits={used} {str(dtype)[6:]}: "
        f"max abs diff {float(diff.max()):.3g}; nearest its limit {float(diff.flatten()[at]):.3g} of "
        f"{float(limit.flatten()[at]):.3g}; limit median {float(limit.median()):.3g} where |plain| has median "
        f"{float(ref.float().abs().median()):.3g} and max {float(ref.float().abs().max()):.3g}")
    if not bool((diff <= limit).all()):
        raise AssertionError(f"memory_readout differs from its plain version by {float(diff.flatten()[at])} "
                             f"where the limit is {float(limit.flatten()[at])}")
    return float(diff.max())


def check_readout_fp64_case(case, device, seed=260) -> float:
    """One case of READOUT_FP64_CASES on the card: the fp32 kernel on matched
    inputs (logits of 30 and more) against a float64 readout: no farther from it
    than twice the plain fp32 version plus READOUT_FP64_TOL, which one TF32 product per
    fp32 product would miss a hundredfold.  Raises where it does not hold; returns
    the largest absolute difference."""
    from yolo_puncture_tpu_torch.ops.kernels.memory_readout import memory_readout_reference

    Q, M, No, valid, n_split = case
    q, k, v, ok = readout_inputs(Q, M, No, 128, torch.float32, seed, device, valid, scale=2.0, match=True)
    got, used = launch_readout(q, k, v, ok, n_split)
    p, l = softmax_weights(q, k, ok, torch.float64)
    ref = torch.matmul(p, v.double()) / l[None]
    err = float((got.double() - ref).abs().max())
    plain_err = float((memory_readout_reference(q, k, v, ok).double() - ref).abs().max())
    s_max = float((torch.matmul(q.double(), k.double().T).abs() * ok[None, :]).max()) / 8.0
    log(f"memory_readout Q={Q} M={M} No={No} valid={valid} splits={used} fp32 on matched inputs, |s| up to "
        f"{s_max:.1f}: max abs diff to a float64 readout {err:.3g} (the plain fp32 version {plain_err:.3g}; "
        f"limit {2 * plain_err + READOUT_FP64_TOL:.3g})")
    if not (s_max >= 25.0 and err <= 2 * plain_err + READOUT_FP64_TOL):
        raise AssertionError(f"the fp32 readout is {err} from a float64 readout (> {2 * plain_err + READOUT_FP64_TOL}) "
                             f"with logits up to {s_max}")
    return err


def check_memory_readout(device) -> dict:
    """Kernel vs plain version on the card at every case, flat and peaked softmax,
    and the fp32 kernel vs a float64 readout; returns the largest absolute
    difference to the plain version in fp32 and in bf16."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, case in enumerate(READOUT_CASES):
        for dtype in worst:
            for scale in (1.0, 2.0):
                worst[dtype] = max(worst[dtype], check_readout_case(case, dtype, scale, device, 200 + i))
    for i, case in enumerate(READOUT_FP64_CASES):
        check_readout_fp64_case(case, device, 260 + i)
    return worst


def needle_network(device):
    """PropagationNetwork with the shipped needle checkpoint, on ``device``."""
    from yolo_puncture_tpu_torch.track.network import PropagationNetwork
    from yolo_puncture_tpu_torch.utils.convert import (
        export_tracker_state_dict,
        load_tracker_state_dict,
        read_msgpack,
    )

    net = PropagationNetwork()
    load_tracker_state_dict(net, export_tracker_state_dict(read_msgpack(NEEDLE)))
    return net.to(device).eval()


def tail_inputs(N, No, H16, W16, dtype, seed, device):
    """Seeded hidden (N, No, H16, W16, 128), f8p (N, H8, W8, 64), f4p (N, H4, W4, 64)."""
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)  # noqa: E731
    return (to(rng.standard_normal((N, No, H16, W16, 128))),
            to(0.5 * rng.standard_normal((N, 2 * H16, 2 * W16, 64))),
            to(0.5 * rng.standard_normal((N, 4 * H16, 4 * W16, 64))))


# (N, No, H16, W16): the window, one frame, then shapes that leave the kernel's 32 x 8
# pixel tiles ragged in both stages, down to a single pixel
TAIL_CASES = [(5, 4, 30, 54), (1, 4, 30, 54), (2, 3, 5, 7), (3, 1, 1, 1), (2, 1, 7, 9), (1, 3, 17, 33)]
TAIL_TOL = {torch.float32: FP32_TOL, torch.bfloat16: TAIL_BF16_TOL}


def check_decode_tail_case(params, case, device, seed=300) -> float:
    """One case of TAIL_CASES on the card in the type ``params`` were prepared
    for, kernel against plain version (the packed algebra through cuDNN, TF32
    off), within TAIL_TOL.  Raises where they disagree; returns the largest
    absolute difference."""
    from yolo_puncture_tpu_torch.ops.kernels.decode_tail import decode_tail, decode_tail_reference

    N, No, H16, W16 = case
    dtype, tol = params.dtype, TAIL_TOL[params.dtype]
    hidden, f8p, f4p = tail_inputs(N, No, H16, W16, dtype, seed, device)
    got = decode_tail(params, hidden, f8p, f4p)
    ref = decode_tail_reference(params, hidden, f8p, f4p)
    torch.cuda.synchronize()
    if got.dtype != torch.float32 or tuple(got.shape) != (N, No, 4 * H16, 4 * W16) \
            or not torch.isfinite(got).all():
        raise AssertionError(f"decode_tail gave {got.dtype} {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    log(f"decode_tail N={N} No={No} {H16}x{W16} {str(dtype)[6:]}: max abs diff {err:.3g} "
        f"(tol {tol:.3g}, logits up to {float(ref.abs().max()):.3g})")
    if not err <= tol:
        raise AssertionError(f"decode_tail differs from its plain version by {err} > {tol}")
    return err


def check_decode_tail(net, device) -> dict:
    """Kernel vs plain version on the card at every case, with the needle
    checkpoint's decoder; returns the largest difference in fp32 and in bf16."""
    worst = {}
    for dtype in TAIL_TOL:
        params = net.decoder.tail_params(dtype)
        worst[dtype] = max(check_decode_tail_case(params, case, device, 300 + i)
                           for i, case in enumerate(TAIL_CASES))
    return worst


def bar_frames(n: int, h: int, w: int, seed: int):
    """RGB uint8 frames of a bright bar moving right over noise, and the bar's
    boolean masks (n, h, w)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 60, (n, h, w, 3)).astype(np.uint8)
    masks = np.zeros((n, h, w), bool)
    for i in range(n):
        x0, y0 = 200 + 12 * i, 300 + 2 * i
        masks[i, y0:y0 + 60, x0:x0 + 360] = True
        frames[i][masks[i]] = 230
    return frames, masks


def drive_tracker(core, frames, masks, upto_first_window: bool = False):
    """incorporate_detection with the bar's id mask, 5× step, then step_batch:
    of 12 frames and a second incorporate_detection, or (``upto_first_window``)
    of the first 5 frames only.  Returns the probabilities (T, No+1, H, W)."""
    from yolo_puncture_tpu_torch.track import ObjectInfo

    probs = [core.incorporate_detection(frames[0], masks[0].astype(np.int32), [ObjectInfo(id=1)])]
    for i in range(1, 6):
        probs.append(core.step(frames[i]))
    if upto_first_window:
        return np.stack(probs + list(core.step_batch(list(frames[6:11]))))
    probs += list(core.step_batch(list(frames[6:18])))
    probs.append(core.incorporate_detection(frames[18], masks[18].astype(np.int32), [ObjectInfo(id=1)]))
    return np.stack(probs)


def needle_clip(n: int, h: int, w: int, key_frame: int, seed: int):
    """BGR uint8 frames (n, h, w, 3) of a needle over textured skin, drawn as
    ``tools/e2e_accuracy_eval.py make_puncture_video`` draws its clips: a bright
    vertical shaft ending at the skin line, its visible length constant until
    ``key_frame`` and then shrinking by 1 % of it a frame, with an insertion cue
    at the entry point from the key frame on.  Returns (frames, the shaft's
    boxes (n, 4) xyxy, its visible lengths (n,) in pixels)."""
    rng = np.random.default_rng(seed)
    skin_y, length0, half_w = int(h * 0.7), h * 0.4, max(w // 100, 2)
    cx = int(rng.integers(w // 3, 2 * w // 3))
    base = rng.integers(60, 120, (h, w, 3)).astype(np.int32)
    base[skin_y:] = (115, 128, 166)
    frames = np.empty((n, h, w, 3), np.uint8)
    boxes, lens = np.zeros((n, 4), np.float32), np.zeros(n, np.float32)
    for t in range(n):
        img = base + rng.integers(-6, 7, (h, w, 3))
        vis = length0 * (1.0 - 0.01 * max(t - key_frame, 0))
        jx = int(rng.integers(-1, 2))
        x1, x2, y1 = cx - half_w + jx, cx + half_w + jx, int(round(skin_y - vis))
        img[y1:skin_y, x1:x2] = 235
        if t >= key_frame:
            img[skin_y - 3:skin_y + 4, x1 - 4:x2 + 4] = (60, 60, 240)
        frames[t] = np.clip(img, 0, 255)
        boxes[t], lens[t] = (x1, y1, x2, skin_y), skin_y - y1
    return frames, boxes, lens


def pipeline_conf(pipe, frames) -> tuple:
    """A conf between two of the clip's best scores (one device step per batch at
    conf 0): the middle of the widest gap between neighbours among the sorted
    scores, leaving at least an eighth of the frames on each side, so that some
    frames are detected and some are not and no score lies near the threshold.
    Returns (conf, the gap)."""
    B = pipe.device_batch
    best = np.sort(np.concatenate([
        pipe._step(torch.from_numpy(frames[i:i + B]).to(pipe.detector.device), 0.0)[0]["conf"].cpu().numpy()
        for i in range(0, len(frames), B)]))
    lo, hi = max(len(best) // 8, 1) - 1, len(best) - max(len(best) // 8, 1)
    i = lo + int(np.argmax(np.diff(best)[lo:hi]))
    return float((best[i] + best[i + 1]) / 2), float(best[i + 1] - best[i])


def check_pipeline_output(out, n_frames, h, w) -> dict:
    """What the speed pipeline returns for a clip: one entry per frame in every
    list, finite lengths, classes repaired to 0 before the key frame and 1 after
    it, and the fallback chain (an undetected frame repeats the last detection's
    box and length, the whole frame before any detection)."""
    lists = {k: len(getattr(out, k)) for k in ("lens", "smooth_lens", "actual_lens", "classes", "probs", "boxes",
                                               "detected")}
    if set(lists.values()) != {n_frames}:
        raise AssertionError(f"pipeline output lengths {lists}, want {n_frames} each")
    if not (np.isfinite(out.lens).all() and np.isfinite(out.smooth_lens).all()):
        raise AssertionError("non-finite lengths")
    s = out.start_frame
    if not (0 <= s < n_frames and set(out.classes[:s]) <= {0} and set(out.classes[s + 1:]) <= {1}):
        raise AssertionError(f"classes not repaired around the key frame {s}: {out.classes}")
    if not all(0.0 <= p <= 1.0 for p in out.probs):
        raise AssertionError("probabilities outside [0, 1]")
    last_box, last_len = (0, 0, w, h), 0.0
    for box, length, det in zip(out.boxes, out.lens, out.detected):
        if det:
            last_box, last_len = box, length
        elif (box, length) != (last_box, last_len):
            raise AssertionError(f"fallback chain broken: {box}, {length} after {last_box}, {last_len}")
    return {"detected": int(sum(out.detected)), "start_frame": s, "end_frame": out.end_frame,
            "speed_mm_s": out.speed_mm_s, "lens": [round(v, 3) for v in out.lens[::6]]}


def same_pipeline_output(got, ref) -> None:
    """Raise unless two runs of the pipeline over one clip agree: detections,
    boxes, classes, key frame and end frame equal, lengths within 1e-4 px and
    probabilities within 1e-5."""
    equal = all(getattr(got, k) == getattr(ref, k)
                for k in ("detected", "boxes", "classes", "start_frame", "end_frame"))
    close = (np.allclose(got.lens, ref.lens, rtol=1e-5, atol=1e-4)
             and np.allclose(got.probs, ref.probs, rtol=0, atol=1e-5))
    if not (equal and close):
        raise AssertionError(f"interleaved and sequential runs differ: {got} against {ref}")


# the speed pipeline's device step on the card against its CPU run (one batch, same weights)
PIPE_BOX_TOL = 0.05       # float boxes, pixels of the original frame
PIPE_CONF_TOL = 1e-4
PIPE_MASK_AGREE = 0.999   # share of equal pixels of each frame's mask at letterbox resolution
PIPE_PROB_TOL = 1e-3      # classifier probability, where both sides cut the crop at the same integer origin


def check_pipeline_step(got: dict, ref: dict) -> dict:
    """One batch of ``VideoSpeedPipeline._step`` on the card (``got``) against the
    CPU (``ref``), both as numpy: ``valid`` equal, boxes within PIPE_BOX_TOL,
    scores within PIPE_CONF_TOL, masks PIPE_MASK_AGREE equal, probabilities within
    PIPE_PROB_TOL where the crop origin is the same.  Raises where they disagree."""
    if not np.array_equal(got["valid"], ref["valid"]):
        raise AssertionError(f"valid differs: {got['valid']} against {ref['valid']}")
    origin = [np.stack([((b[:, 0] + b[:, 2]) / 2).astype(np.int32), ((b[:, 1] + b[:, 3]) / 2).astype(np.int32)], 1)
              for b in (got["box"], ref["box"])]
    same = (origin[0] == origin[1]).all(1)
    stats = {"frames": len(got["valid"]), "valid": int(ref["valid"].sum()),
             "box_max_abs": float(np.abs(got["box"] - ref["box"]).max()),
             "conf_max_abs": float(np.abs(got["conf"] - ref["conf"]).max()),
             "mask_min_agreement": float(min((g == r).mean() for g, r in zip(got["mask_lb"], ref["mask_lb"]))),
             "same_crop_origin": int(same.sum()),
             "prob_max_abs": float(np.abs(got["cls_prob"] - ref["cls_prob"])[same].max()) if same.any() else 0.0}
    if not (stats["box_max_abs"] <= PIPE_BOX_TOL and stats["conf_max_abs"] <= PIPE_CONF_TOL
            and stats["mask_min_agreement"] >= PIPE_MASK_AGREE and stats["prob_max_abs"] <= PIPE_PROB_TOL
            and stats["same_crop_origin"] > 0):
        raise AssertionError(f"the pipeline step on the card disagrees with the CPU: {stats}")
    return stats


def pipeline_step_numpy(pipe, frames_u8, conf: float) -> dict:
    """``pipe._step`` on one batch of BGR frames, on the pipeline's device, as numpy."""
    res, _, _ = pipe._step(torch.from_numpy(frames_u8).to(pipe.detector.device), conf)
    return {k: v.cpu().numpy() for k, v in res.items() if v is not None}


def pipeline_stage_ms(pipe, frames, conf: float) -> dict:
    """One ``process_frames`` over ``frames`` with the device step's stages timed on
    the host clock, the device synchronised before and after each (so nothing
    overlaps as it does in an unclocked call), plus the pipeline's own host
    stages (``StageTimer``): ms summed over the clip.  'submit_rest' is what the
    submit stage holds besides the clocked device stages: stacking the frames
    into pinned memory, the upload, the box scaling and the queued copies."""
    import yolo_puncture_tpu_torch.pipeline.runner as pr
    from yolo_puncture_tpu_torch.utils.profiling import StageTimer

    ms = dict.fromkeys(("letterbox", "model", "select", "decode", "crops", "classifier"), 0.0)

    def clocked(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            ms[name] += (time.perf_counter() - t) * 1e3
            return out
        return run

    patched = {"letterbox": "letterbox", "select_detections": "select", "decode_masks": "decode"}
    saved = {attr: getattr(pr, attr) for attr in patched}
    model, timer, cls = pipe.detector.model, pipe.timer, pipe.classifier
    forward, predict = cls._forward, cls.predict
    in_step = clocked("classifier", forward)

    def predict_unclocked(images):  # the host pass's re-classification stays in its own stage
        cls._forward = forward
        try:
            return predict(images)
        finally:
            cls._forward = in_step

    try:
        for attr, stage in patched.items():
            setattr(pr, attr, clocked(stage, saved[attr]))
        pipe.detector.model = clocked("model", model)
        pipe._crops = clocked("crops", pipe._crops)
        cls._forward, cls.predict = in_step, predict_unclocked
        pipe.timer = StageTimer()
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipe.process_frames(list(frames), fps=30.0, conf=conf)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
        host = {k: v["total_s"] * 1e3 for k, v in pipe.timer.summary().items()}
    finally:
        for attr, fn in saved.items():
            setattr(pr, attr, fn)
        pipe.detector.model, pipe.timer = model, timer
        del pipe._crops, cls._forward, cls.predict
    ms["submit_rest"] = host["device_submit"] - sum(ms.values())
    ms.update({k: v for k, v in host.items() if k != "device_submit"})
    ms["total"] = total
    return ms


def check_tracker_probs(probs, n_frames, core):
    h, w = core.image_size
    if probs.shape != (n_frames, core.max_objects + 1, h, w) or not np.isfinite(probs).all():
        raise AssertionError(f"tracker probabilities: shape {probs.shape}, finite {np.isfinite(probs).all()}")
    off = float(np.abs(probs.sum(1) - 1.0).max())
    if off > 1e-4:
        raise AssertionError(f"probabilities do not sum to 1 over the objects (off by {off})")


def bar_iou(probs, masks, image_size) -> list:
    """IoU of the tracked id (argmax == 1) against the bar, per frame, at the tracker's size."""
    from yolo_puncture_tpu_torch.ops.resize import resize_nearest

    out = []
    for p, m in zip(probs, masks):
        ref = resize_nearest(m.astype(np.int32), image_size) > 0
        got = p.argmax(0) == 1
        out.append(round(float((ref & got).sum() / max((ref | got).sum(), 1)), 4))
    return out


def sdpa_yardstick(q, k, v, ok):
    """One PyTorch call that computes the readout: scaled_dot_product_attention with
    a boolean mask, the objects folded into the value's width or, if no backend
    takes that, as heads.  Returns (what it is, a function) or (None, None)."""
    import torch.nn.functional as F

    No, M, Cv = v.shape
    mask = ok[None, None, None, :]
    q4, k4 = q[None, None], k[None, None]
    folded = v.permute(1, 0, 2).reshape(1, 1, M, No * Cv).contiguous()
    heads = v[None].contiguous()
    forms = [
        ("scaled_dot_product_attention, objects folded into the value width",
         lambda: F.scaled_dot_product_attention(q4, k4, folded, attn_mask=mask)),
        ("scaled_dot_product_attention, objects as heads",
         lambda: F.scaled_dot_product_attention(q4.expand(1, No, -1, -1), k4.expand(1, No, -1, -1), heads,
                                                attn_mask=mask)),
    ]
    for what, fn in forms:
        try:
            out = fn()
            torch.cuda.synchronize()
        except RuntimeError as e:
            log(f"yardstick '{what}' refused: {str(e).splitlines()[0]}")
            continue
        return what, fn, out
    return None, None, None


def host_ms(fn, repeats: int = 3) -> list:
    """Host-clock times of ``fn()`` in ms, the device synchronised before and after."""
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def roofline_ms(name, bytes_moved, flops, flop_rate):
    """(bound in ms, 'bytes' or 'operations'): the larger of the bytes over the
    memory rate and the operations over ``flop_rate``, the card's peak for the
    type the kernel multiplies in."""
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / flop_rate * 1e3
    log(f"{name}: bound {max(bound_bytes_ms, bound_ops_ms):.5f} ms "
        f"(bytes {bound_bytes_ms:.5f} ms, operations {bound_ops_ms:.5f} ms at {flop_rate / 1e12:.0f} TFLOP/s)")
    return max(bound_bytes_ms, bound_ops_ms), "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"


def kernel_entry(name, source, replaces, launches, max_err, ms, plain_ms, library_ms, bytes_moved, flops,
                 flop_rate) -> dict:
    """One entry of the ``kernels`` line."""
    bound_ms, bound_by = roofline_ms(name, bytes_moved, flops, flop_rate)
    return {
        "name": name,
        "route": "cuda",
        "source": f"yolo_puncture_tpu_torch/csrc/{source}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def interleaved_times_ms(fns: dict, launches: int = 200, repeats: int = 5) -> dict:
    """{name: sorted mean times of ``launches`` back-to-back calls}, ``repeats``
    of them each, taken in turns so that a drift of the card hits all alike."""
    out = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            out[name].append(cuda_time_ms(fn, iters=launches))
    return {name: sorted(v) for name, v in out.items()}


def tracker_stage_ms(core, frames) -> dict:
    """One window (``step_batch`` of ``mem_every`` frames) and as many ``step``
    calls, with the tracker's stages timed on the host clock, the device
    synchronised before and after each stage.  'rest' is what remains of each
    call: the frame resizes, soft aggregation, the upsample of the logits, the
    memory-bank concatenation and the copy of the probabilities to the host."""
    import yolo_puncture_tpu_torch.track.core as tc

    out = {}
    for mode in ("window", "steps"):
        ms = dict.fromkeys(("encode", "readout", "head_sensory", "decode_tail", "write"), 0.0)

        def clocked(name, fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = fn(*a, **k)
                torch.cuda.synchronize()
                ms[name] += (time.perf_counter() - t) * 1e3
                return res
            return run

        net = core.net
        saved_kernel = tc.memory_readout_kernel
        patched = {"encode_key": "encode", "update_sensory": "head_sensory", "encode_value": "write"}
        try:
            tc.memory_readout_kernel = clocked("readout", saved_kernel)
            for attr, stage in patched.items():
                setattr(net, attr, clocked(stage, getattr(net, attr)))
            # both the per-frame decoder and the windowed path reach head and tail here
            net.decoder.head = clocked("head_sensory", net.decoder.head)
            net.decoder.decode_tail = clocked("decode_tail", net.decoder.decode_tail)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if mode == "window":
                core.step_batch(frames)
            else:
                for f in frames:
                    core.step(f)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t) * 1e3
        finally:
            tc.memory_readout_kernel = saved_kernel
            for attr in patched:
                delattr(net, attr)
            del net.decoder.head, net.decoder.decode_tail
        ms["rest"] = total - sum(ms.values())
        ms["total"] = total
        out[mode] = ms
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from yolo_puncture_tpu_torch import YOLO, _build
    from yolo_puncture_tpu_torch.ops.kernels import decode_tail as dt
    from yolo_puncture_tpu_torch.ops.kernels import memory_readout as mr
    from yolo_puncture_tpu_torch.ops.kernels.proto_decode import (
        kernel_args,
        kernel_fn,
        proto_decode,
        proto_decode_reference,
    )
    from yolo_puncture_tpu_torch.pipeline import VideoSpeedPipeline
    from yolo_puncture_tpu_torch.tasks import ClassifierNet
    from yolo_puncture_tpu_torch.track import ObjectInfo, TrackerCore
    from yolo_puncture_tpu_torch.track.network import memory_readout_dense
    from yolo_puncture_tpu_torch.utils.profiling import StageTimer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    t0 = time.perf_counter()
    built = _build.build_all(verbose=True)
    log(f"built {built} in {time.perf_counter() - t0:.1f} s")
    if sorted(built) != ["decode_tail", "memory_readout", "proto_decode"]:
        raise AssertionError(f"expected three kernel sources, found {built}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # -- 2. kernels against their plain versions -------------------------------
    net = needle_network(device)
    readout_err = check_memory_readout(device)
    tail_err = check_decode_tail(net, device)
    max_err = {"proto_decode": check_proto_decode(device),
               "memory_readout": readout_err[torch.float32],
               "memory_readout_bf16": readout_err[torch.bfloat16],
               "decode_tail": tail_err[torch.float32],
               "decode_tail_bf16": tail_err[torch.bfloat16]}

    # -- 3a. main path of the detector ----------------------------------------------
    n_frames, h0, w0, imgsz, conf = 4, 720, 1280, 640, 0.018
    frames = seeded_frames(n_frames, h0, w0, seed=0)
    det = YOLO("yolo10s-seg", nc=1, seed=0)
    proto_decode.launches = 0
    res_plain = det.predict(list(frames), conf=conf, imgsz=imgsz, retina_masks=False)
    res_retina = det.predict(list(frames), conf=conf, imgsz=imgsz, retina_masks=True)
    torch.cuda.synchronize()
    launches = {"proto_decode": proto_decode.launches}
    log(f"main path (predict): proto_decode launched {launches['proto_decode']} times")
    if launches["proto_decode"] <= 0:
        raise AssertionError("the main path did not launch the proto_decode kernel")
    for name, res in (("non-retina", res_plain), ("retina", res_retina)):
        counts, px = check_results(res, n_frames, h0, w0)
        log(f"{name}: detections per frame {counts}, mask pixels {px}")

    # -- 3b. main path of the tracker ---------------------------------------------------
    track_frames, track_masks = bar_frames(19, h0, w0, seed=1)
    core = TrackerCore(enable_long_term=False, variables=NEEDLE, **TRACK_GEOMETRY)
    mr.memory_readout.launches = dt.decode_tail.launches = 0
    probs = drive_tracker(core, track_frames, track_masks)
    torch.cuda.synchronize()
    launches["memory_readout"] = mr.memory_readout.launches
    launches["decode_tail"] = dt.decode_tail.launches
    log(f"main path (tracker, 19 frames): memory_readout launched {launches['memory_readout']} times, "
        f"decode_tail {launches['decode_tail']} times")
    if launches["memory_readout"] <= 0 or launches["decode_tail"] <= 0:
        raise AssertionError("the tracker path did not launch both of its kernels")
    check_tracker_probs(probs, 19, core)
    if sorted(core.object_manager.all_obj_ids) != [1] or not core.memory_engaged:
        raise AssertionError(f"tracker bookkeeping: ids {core.object_manager.all_obj_ids}")
    log(f"tracker: IoU of the tracked id against the bar per frame {bar_iou(probs, track_masks, core.image_size)}, "
        f"ring valid {core.memory.valid.tolist()}, write_pos {core.memory.write_pos}, "
        f"frame_idx {core.memory.frame_idx}")

    # -- 3c. the tracker in bf16, against the fp32 run above ------------------------------------
    core16 = TrackerCore(enable_long_term=False, variables=NEEDLE, dtype=torch.bfloat16, **TRACK_GEOMETRY)
    mr.memory_readout.launches = dt.decode_tail.launches = 0
    probs16 = drive_tracker(core16, track_frames, track_masks, upto_first_window=True)
    torch.cuda.synchronize()
    launches["memory_readout_bf16"] = mr.memory_readout.launches
    launches["decode_tail_bf16"] = dt.decode_tail.launches
    check_tracker_probs(probs16, 11, core16)
    prob_err16 = float(np.abs(probs16 - probs[:11]).max())
    id_agree16 = float((probs16.argmax(1) == probs[:11].argmax(1)).mean())
    log(f"tracker in bf16 vs fp32 on the card, 11 frames (incorporate, 5 steps, one window): memory_readout launched "
        f"{launches['memory_readout_bf16']} times, decode_tail {launches['decode_tail_bf16']}; max abs prob diff "
        f"{prob_err16:.3g} (tol {TRACK_BF16_PROB_TOL}), id maps equal {id_agree16:.6f} (at least "
        f"{TRACK_BF16_ID_AGREE}), IoU {bar_iou(probs16, track_masks, core16.image_size)}")
    if launches["memory_readout_bf16"] <= 0 or launches["decode_tail_bf16"] <= 0:
        raise AssertionError("the bf16 tracker did not launch both of its kernels")
    if not (prob_err16 <= TRACK_BF16_PROB_TOL and id_agree16 >= TRACK_BF16_ID_AGREE):
        raise AssertionError("the bf16 tracker disagrees with the fp32 tracker")

    # -- 3d. main path of the speed pipeline ------------------------------------------------
    clip, _, _ = needle_clip(PIPE_FRAMES, h0, w0, PIPE_KEY_FRAME, seed=2)
    pipe = VideoSpeedPipeline(YOLO("yolo10s-seg", nc=1, seed=0), ClassifierNet("efficientnet_b3", seed=0),
                              device_batch=8, imgsz=imgsz, crop_size=380)
    pipe_conf, gap = pipeline_conf(pipe, clip)
    n_batches = -(-PIPE_FRAMES // pipe.device_batch)
    proto_decode.launches = 0
    pipe_out = pipe.process_frames(list(clip), fps=30.0, conf=pipe_conf)
    torch.cuda.synchronize()
    launches["proto_decode_pipeline"] = proto_decode.launches
    summary = check_pipeline_output(pipe_out, PIPE_FRAMES, h0, w0)
    log(f"main path (speed pipeline: {PIPE_FRAMES} frames {h0}x{w0} -> {imgsz}^2, YOLOv10-S seg, EfficientNet-B3 on "
        f"380^2 crops, device_batch 8, conf {pipe_conf:.6f} in a gap of {gap:.3g} between best scores): proto_decode "
        f"launched {proto_decode.launches} times for {n_batches} batches; host re-classification of "
        f"{pipe.timer.counts['host_classify']} clip(s); {json.dumps(summary)}")
    if proto_decode.launches != n_batches:
        raise AssertionError(f"the pipeline launched proto_decode {proto_decode.launches} times for {n_batches} batches")
    if not 0 < summary["detected"] < PIPE_FRAMES or pipe.timer.counts["host_classify"] != 1:
        raise AssertionError("the clip must have detected and undetected frames, and the host must re-classify")
    # two clips of one resolution through the interleaved batches, each against its own run
    clip_b, _, _ = needle_clip(24, h0, w0, 8, seed=3)
    streams = lambda: [("a", 30.0, (h0, w0), iter(clip[:32])), ("b", 25.0, (h0, w0), iter(clip_b))]  # noqa: E731
    proto_decode.launches = 0
    batched = pipe._process_streams(streams(), pipe_conf, 20)
    interleaved_launches = proto_decode.launches
    sequential = pipe._process_streams(streams(), pipe_conf, 20, interleave=False)
    for name in ("a", "b"):
        same_pipeline_output(batched[name], sequential[name])
    log(f"interleaved videos a (32 frames) and b (24): proto_decode launched {interleaved_launches} times "
        f"(7 shared batches); each equals its own run: "
        f"{json.dumps({n: check_pipeline_output(o, len(o.lens), h0, w0) for n, o in batched.items()})}")

    # -- 4. the same calls on the CPU ------------------------------------------------------
    det_cpu = YOLO("yolo10s-seg", nc=1, seed=0, device="cpu")
    for name, res, retina in (("non-retina", res_plain, False), ("retina", res_retina, True)):
        cpu = det_cpu.predict(frames[0], conf=conf, imgsz=imgsz, retina_masks=retina)[0]
        log(f"GPU vs CPU {name}: {json.dumps(compare_to_cpu(res[0], cpu))}")
    t = time.perf_counter()
    core_cpu = TrackerCore(enable_long_term=False, variables=NEEDLE, device="cpu", **TRACK_GEOMETRY)
    probs_cpu = drive_tracker(core_cpu, track_frames, track_masks, upto_first_window=True)
    prob_err = float(np.abs(probs[:11] - probs_cpu).max())
    id_agree = float((probs[:11].argmax(1) == probs_cpu.argmax(1)).mean())
    log(f"tracker GPU vs CPU, 11 frames (incorporate, 5 steps, one window): max abs prob diff {prob_err:.3g} "
        f"(tol {TRACK_PROB_TOL}), id maps equal {id_agree:.6f} (at least {TRACK_ID_AGREE}); "
        f"the CPU run took {time.perf_counter() - t:.1f} s")
    if not (prob_err <= TRACK_PROB_TOL and id_agree >= TRACK_ID_AGREE):
        raise AssertionError("the tracker on the card disagrees with its CPU run")
    del core_cpu, probs_cpu
    # the pipeline's device step: the batch of the clip with the most even split of detections
    t = time.perf_counter()
    pipe_cpu = VideoSpeedPipeline(YOLO("yolo10s-seg", nc=1, seed=0, device="cpu"),
                                  ClassifierNet("efficientnet_b3", seed=0, device="cpu"),
                                  device_batch=8, imgsz=imgsz, crop_size=380)
    det_per_batch = [sum(pipe_out.detected[i:i + 8]) for i in range(0, PIPE_FRAMES - 7, 8)]
    b0 = 8 * int(np.argmin([abs(d - 4) for d in det_per_batch]))
    stats = check_pipeline_step(pipeline_step_numpy(pipe, clip[b0:b0 + 8], pipe_conf),
                                pipeline_step_numpy(pipe_cpu, clip[b0:b0 + 8], pipe_conf))
    log(f"pipeline step GPU vs CPU, frames {b0}-{b0 + 7}: {json.dumps(stats)} (limits: valid equal, boxes "
        f"{PIPE_BOX_TOL} px, conf {PIPE_CONF_TOL}, masks {PIPE_MASK_AGREE}, probabilities {PIPE_PROB_TOL}); "
        f"the CPU run took {time.perf_counter() - t:.1f} s")
    del pipe_cpu

    # -- 5. long-term memory on: the plain readout with usage, and consolidation ----------------
    before = mr.memory_readout.launches
    for what, kw in (("the constructor's defaults", {}),
                     ("a ring of two slots", dict(max_objects=4, mem_frames=2, mem_every=2))):
        core_lt = TrackerCore(variables=NEEDLE, **kw)
        probs_lt = [core_lt.incorporate_detection(track_frames[0], track_masks[0].astype(np.int32), [ObjectInfo(id=1)])]
        probs_lt += [core_lt.step(f) for f in track_frames[1:7]]
        probs_lt = np.stack(probs_lt)
        check_tracker_probs(probs_lt, 7, core_lt)
        if not core_lt.enable_long_term or float(core_lt.memory.usage.sum()) <= 0:
            raise AssertionError("the long-term configuration accumulated no attention usage")
        if kw and not bool(core_lt.memory.lt_valid.any()):
            raise AssertionError("the two-slot ring never consolidated into the long-term bank")
        log(f"long-term memory, {what}, 7 frames: {int(core_lt.memory.lt_valid.sum())} prototypes, "
            f"IoU {bar_iou(probs_lt, track_masks, core_lt.image_size)}")
        del core_lt, probs_lt
    if mr.memory_readout.launches != before:
        raise AssertionError("the long-term configuration must read through memory_readout_dense")

    # -- 6a. proto_decode at the detector's shapes -------------------------------------------
    B, N, Hp, Wp, nm = n_frames, det.max_masks, imgsz // 4, imgsz // 4, 32
    launch = kernel_fn()
    # the batch; one frame, which is also what the predictor launches for a frame with more
    # than max_masks detections (predictor.py _overflow: B 1, N max_masks); eight frames
    for Bt in (B, 1, 8):
        protos, coeffs, boxes = proto_decode_inputs(Bt, N, Hp, Wp, nm, 7, device)
        out = torch.empty((Bt, N, Hp, Wp), dtype=torch.float32, device=device)
        args = kernel_args(protos, coeffs, boxes, out, None, True)
        pflat = protos.reshape(Bt, nm, Hp * Wp)
        fns = {"kernel": lambda: launch(*args),
               "plain": lambda: proto_decode_reference(protos, coeffs, boxes, None, True),
               "matmul": lambda: torch.matmul(coeffs, pflat)}
        # the bare launch (device time), its plain version and the product alone through cuBLAS, in turns
        times = interleaved_times_ms(fns)
        def raw(threshold):
            a = kernel_args(protos, coeffs, boxes, out, threshold, True)   # binds the current stream
            return lambda: launch(*a)

        makers = {"kernel": lambda: raw(None), "matmul": lambda: fns["matmul"],
                  "kernel, binary by the logit": lambda: raw(0.5)}
        graph = {n: sorted(graph_time_ms(make) for _ in range(5)) for n, make in makers.items()}
        spread = "; ".join(f"{n} min {t[0]:.5f} median {t[2]:.5f} max {t[-1]:.5f}" for n, t in times.items())
        gspread = "; ".join(f"{n} min {t[0]:.5f} median {t[2]:.5f} max {t[-1]:.5f}" for n, t in graph.items())
        tk, tm = times["kernel"], times["matmul"]
        order = ("every kernel repeat is below every matmul repeat" if tk[-1] < tm[0] else
                 "every matmul repeat is below every kernel repeat" if tm[-1] < tk[0] else "the repeats overlap")
        gk, gm = graph["kernel"], graph["matmul"]
        gorder = ("every kernel repeat is below every matmul repeat" if gk[-1] < gm[0] else
                  "every matmul repeat is below every kernel repeat" if gm[-1] < gk[0] else "the repeats overlap")
        P = Hp * Wp
        bytes_moved = 4 * (Bt * nm * P + Bt * N * nm + Bt * N * 4 + Bt * N * P)
        flops = 2 * Bt * N * P * nm
        log(f"proto_decode B={Bt} N={N} {Hp}x{Wp}, ms over 5 repeats of 200 launches from Python: {spread}; {order}. "
            f"Replayed from a CUDA graph of 20 (5 repeats of 10 replays): {gspread}; {gorder} "
            f"({bytes_moved} B, {flops} FLOP) [{smi}]")
        if Bt == B:
            wrapper_ms = cuda_time_ms(lambda: proto_decode(protos, coeffs, boxes, None, True), iters=200)
            log(f"proto_decode through the Python wrapper {wrapper_ms:.5f} ms")
            kernels = [kernel_entry("proto_decode", "proto_decode", "yolo_puncture_tpu/ops/pallas/proto_decode.py:23",
                                    launches["proto_decode"] + launches["proto_decode_pipeline"],
                                    max_err["proto_decode"], times["kernel"][2],
                                    times["plain"][2], times["matmul"][2], bytes_moved, flops, FP32_FLOP_PER_S)]
        else:
            roofline_ms(f"proto_decode B={Bt}", bytes_moved, flops, FP32_FLOP_PER_S)
    del protos, coeffs, boxes, out, pflat

    for retina in (False, True):
        det.predict(list(frames), conf=conf, imgsz=imgsz, retina_masks=retina)  # warm-up
        before = proto_decode.launches
        times = host_ms(lambda: det.predict(list(frames), conf=conf, imgsz=imgsz, retina_masks=retina))
        per_call = (proto_decode.launches - before) // len(times)
        log(f"predict B={B} {h0}x{w0}@{imgsz} retina={retina}: {sorted(times)[1]:.1f} ms median of 3 "
            f"({times}), proto_decode launches per call {per_call} [{smi}]")
        stages = predict_stage_ms(det, list(frames), conf=conf, imgsz=imgsz, retina_masks=retina)
        log(f"predict stages ms, synchronised, retina={retina}: {json.dumps(stages)}")

    # -- 6b. memory_readout at the tracker's shapes: ring full, 8 long-term slots invalid ----
    No, M, Cv, HW = 4, 12968, 128, 1620
    for Q, dtype, keep in ((8100, torch.float32, True), (1620, torch.float32, False),
                           (8100, torch.bfloat16, True), (1620, torch.bfloat16, False)):
        q, k, v, ok = readout_inputs(Q, M, No, Cv, dtype, 11, device)
        ok[8 * HW:] = False
        out = torch.empty((No, Q, Cv), dtype=dtype, device=device)
        n_split = mr.split_for(Q, M, device)
        scratch = mr.kernel_scratch(q, v, n_split)
        # the raw launch: validity pre-pass, readout and (memory split) combine, scratch allocated once
        args, launch = mr.kernel_args(q, k, v, ok, out, scratch, n_split), mr.kernel_fn()
        ms = cuda_time_ms(lambda: launch(*args), iters=20, warmup=3)
        wrapper = cuda_time_ms(lambda: mr.memory_readout(q, k, v, ok), iters=20, warmup=3)
        plain = cuda_time_ms(lambda: mr.memory_readout_reference(q, k, v, ok), iters=10, warmup=2)
        dense = cuda_time_ms(lambda: memory_readout_dense(q, k, v, ok), iters=10, warmup=2)
        what, fn, lib_out = sdpa_yardstick(q, k, v, ok)
        lib = None
        if fn is not None:
            lib = cuda_time_ms(fn, iters=10, warmup=2)
            lib_out = lib_out.reshape(Q, No, Cv).permute(1, 0, 2) if lib_out.shape[1] == 1 else lib_out[0]
            log(f"  yardstick '{what}' agrees with the kernel to "
                f"{float((lib_out.float() - mr.memory_readout(q, k, v, ok).float()).abs().max()):.3g}")
        else:
            what, lib = "the two-matmul dense readout (network.memory_readout_dense)", dense
        ms2 = cuda_time_ms(lambda: launch(*args), iters=20, warmup=3)     # again, after the others
        n_valid = int(ok.sum())
        esize = q.element_size()
        flops = 2 * Q * n_valid * (64 + No * Cv)
        bytes_moved = esize * (Q * 64 + n_valid * 64 + No * n_valid * Cv + No * Q * Cv) + M
        log(f"memory_readout Q={Q} M={M} ({n_valid} valid) No={No} Cv={Cv} {str(dtype)[6:]} splits={n_split}: "
            f"kernel {ms:.4f} ms (again {ms2:.4f}; wrapper {wrapper:.4f}), plain {plain:.4f} ms, dense two-matmul "
            f"{dense:.4f} ms, yardstick [{what}] {lib:.4f} ms, ({bytes_moved} B, {flops} FLOP) [{smi}]")
        # fp32 goes through the tensor cores as three TF32 products for every fp32 product
        name, ops, rate = (("memory_readout", 3 * flops, TF32_FLOP_PER_S) if dtype == torch.float32 else
                           ("memory_readout_bf16", flops, BF16_FLOP_PER_S))
        if keep:
            kernels.append(kernel_entry(name, "memory_readout", "yolo_puncture_tpu/ops/pallas/mem_attention.py:24",
                                        launches[name], max_err[name], ms, plain, lib, bytes_moved, ops, rate))
        else:
            roofline_ms(f"{name}, one frame", bytes_moved, ops, rate)
        del q, k, v, ok, out, lib_out

    # -- 6c. decode_tail at the tracker's shapes ------------------------------------------------
    H16, W16 = 30, 54
    for Nf, dtype, keep in ((5, torch.float32, True), (1, torch.float32, False),
                            (5, torch.bfloat16, True), (1, torch.bfloat16, False)):
        params = net.decoder.tail_params(dtype)
        hidden, f8p, f4p = tail_inputs(Nf, 4, H16, W16, dtype, 13, device)
        oskip = dt.skip_plane(params, f4p)
        y8 = torch.empty((Nf * 4, 2 * H16, 2 * W16, 64), dtype=dtype, device=device)
        out = torch.empty((Nf, 4, 4 * H16, 4 * W16), dtype=torch.float32, device=device)
        args, launch = dt.kernel_args(params, hidden, f8p, oskip, y8, out), dt.kernel_fn()
        ms = cuda_time_ms(lambda: launch(*args), iters=20, warmup=3)       # both stages, without the skip plane
        wrapper = cuda_time_ms(lambda: dt.decode_tail(params, hidden, f8p, f4p), iters=20, warmup=3)
        plain = cuda_time_ms(lambda: dt.decode_tail_reference(params, hidden, f8p, f4p), iters=10, warmup=2)
        # yardstick: cuDNN's two packed convolutions alone in the activation type (fp32 with TF32 off), no epilogues
        x8 = hidden.reshape(Nf * 4, H16, W16, 128).permute(0, 3, 1, 2).contiguous()
        x4 = y8.permute(0, 3, 1, 2).contiguous()
        w8 = params.w8.permute(3, 2, 0, 1).contiguous().to(dtype)
        w4 = params.w4.permute(3, 2, 0, 1).contiguous().to(dtype)
        lib = cuda_time_ms(lambda: (F.conv2d(x8, w8, padding=1), F.conv2d(x4, w4, padding=1)), iters=10, warmup=2)
        ms2 = cuda_time_ms(lambda: launch(*args), iters=20, warmup=3)      # again, after the others
        cells, esize = Nf * 4, hidden.element_size()
        flops = 2 * cells * 4 * 256 * (H16 * W16 * 128 + 4 * H16 * W16 * 64) + 2 * cells * 16 * H16 * W16 * 64
        bytes_moved = (esize * (hidden.numel() + f8p.numel() + f4p.numel()) + 4 * out.numel()
                       + params.t8.numel() * params.t8.element_size() + params.t4.numel() * params.t4.element_size()
                       + 4 * (2 * params.a8.numel() + 65))
        log(f"decode_tail N={Nf} No=4 {H16}x{W16} {str(dtype)[6:]}: kernel {ms:.4f} ms (again {ms2:.4f}; wrapper with "
            f"the skip plane {wrapper:.4f}), plain {plain:.4f} ms, cuDNN's two packed convolutions alone {lib:.4f} ms, "
            f"({bytes_moved} B, {flops} FLOP) [{smi}]")
        # fp32 goes through the tensor cores as three TF32 products for every fp32 product
        name, ops, rate = (("decode_tail", 3 * flops, TF32_FLOP_PER_S) if dtype == torch.float32 else
                           ("decode_tail_bf16", flops, BF16_FLOP_PER_S))
        if keep:
            kernels.append(kernel_entry(name, "decode_tail", "yolo_puncture_tpu/ops/pallas/decode_tail.py:52",
                                        launches[name], max_err[name], ms, plain, lib, bytes_moved, ops, rate))
        else:
            roofline_ms(f"{name}, one frame", bytes_moved, ops, rate)
        del hidden, f8p, f4p, oskip, y8, out, x8, x4

    # -- 6d. one step and one window of the tracker, host clock: fp32, then bf16 ----------------------
    step_frames = [track_frames[6 + (i % 4)] for i in range(10)]
    for what, c in (("fp32", core), ("bf16", core16)):
        for i in range(1, 6):
            c.step(track_frames[i])                                          # warm-up
        counts = (mr.memory_readout.launches, dt.decode_tail.launches)
        step_times = host_ms(lambda: [c.step(f) for f in step_frames[:5]])
        per_step = ((mr.memory_readout.launches - counts[0]) / 15, (dt.decode_tail.launches - counts[1]) / 15)
        counts = (mr.memory_readout.launches, dt.decode_tail.launches)
        window_times = host_ms(lambda: c.step_batch(step_frames[:5]))
        per_window = ((mr.memory_readout.launches - counts[0]) / 3, (dt.decode_tail.launches - counts[1]) / 3)
        log(f"tracker {what} 480x864 No=4: 5 steps {sorted(step_times)[1]:.1f} ms median of 3 ({step_times}), "
            f"launches per step (memory_readout, decode_tail) {per_step}; one 5-frame window "
            f"{sorted(window_times)[1]:.1f} ms median of 3 ({window_times}), launches per window {per_window} [{smi}]")
        stages = tracker_stage_ms(c, step_frames[:5])
        log(f"tracker {what} stages ms, synchronised: {json.dumps(stages)}")

    # -- 6e. the speed pipeline: proto_decode at its launch shape, process_frames on the host clock ----
    protos, coeffs, boxes = proto_decode_inputs(8, 1, Hp, Wp, nm, 17, device)
    out = torch.empty((8, 1, Hp, Wp), dtype=torch.float32, device=device)
    launch = kernel_fn()   # the name was rebound to the other kernels' entry points in 6b and 6c
    args = kernel_args(protos, coeffs, boxes, out, None, False)
    pflat = protos.reshape(8, nm, Hp * Wp)
    fns = {"kernel": lambda: launch(*args),
           "plain": lambda: proto_decode_reference(protos, coeffs, boxes, None, False),
           "matmul": lambda: torch.matmul(coeffs, pflat)}
    times = interleaved_times_ms(fns)

    def raw_soft():
        a = kernel_args(protos, coeffs, boxes, out, None, False)   # binds the current stream
        return lambda: launch(*a)

    graph = {"kernel": sorted(graph_time_ms(raw_soft) for _ in range(5)),
             "matmul": sorted(graph_time_ms(lambda: fns["matmul"]) for _ in range(5))}
    P = Hp * Wp
    bytes_moved, flops = 4 * (8 * nm * P + 8 * nm + 8 * 4 + 8 * P), 2 * 8 * P * nm
    roofline_ms("proto_decode B=8 N=1 soft, no crop (the pipeline's launch)", bytes_moved, flops, FP32_FLOP_PER_S)
    log(f"proto_decode B=8 N=1 {Hp}x{Wp} soft, no crop, ms over 5 repeats of 200 launches from Python: "
        + "; ".join(f"{n} min {t[0]:.5f} median {t[2]:.5f} max {t[-1]:.5f}" for n, t in times.items())
        + "; replayed from a CUDA graph of 20: "
        + "; ".join(f"{n} min {t[0]:.5f} median {t[2]:.5f} max {t[-1]:.5f}" for n, t in graph.items())
        + f" ({bytes_moved} B, {flops} FLOP) [{smi}]")
    del protos, coeffs, boxes, out, pflat
    pipe.process_frames(list(clip), fps=30.0, conf=pipe_conf)  # warm-up
    pipe.timer = StageTimer()
    times = host_ms(lambda: pipe.process_frames(list(clip), fps=30.0, conf=pipe_conf))
    median = sorted(times)[1]
    log(f"pipeline {PIPE_FRAMES} frames {h0}x{w0}@{imgsz}, B3 at 380, device_batch 8: {median:.1f} ms median of 3 "
        f"({times}), {PIPE_FRAMES / median * 1e3:.1f} frames/s [{smi}]")
    log(f"pipeline stages over the 3 runs, unsynchronised (StageTimer): {json.dumps(pipe.timer.summary())} [{smi}]")
    stages = pipeline_stage_ms(pipe, clip, pipe_conf)
    log(f"pipeline stages ms over the clip ({n_batches} batches), synchronised: "
        f"{json.dumps({k: round(v, 3) for k, v in stages.items()})} [{smi}]")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
