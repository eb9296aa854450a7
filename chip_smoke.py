#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``yolo_puncture_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):
  1. build every CUDA kernel from ``yolo_puncture_tpu_torch/csrc`` (one nvcc per
     source, in parallel) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card:
     ``proto_decode`` (soft and binary, pixel counts that leave the 4-pixel
     vectors and the blocks ragged, 1 to 70 instances, box edges on vector
     boundaries, the server's padded batches of 2, 8 and 16; bf16 at the bf16
     detector's, pipeline's and bench's shapes),
     ``memory_readout`` (fp32 and bf16, ragged shapes, odd
     object counts, the memory split over blocks, a softmax spread over the
     memory and one carried by a few elements; fp32 also against a float64
     readout on large logits; with ``affinity_bf16`` at the bench's and the
     tracker's shapes) and ``decode_tail`` (fp32 and bf16, the window,
     one frame, shapes down to a single pixel, and the bench's 128 × 2 cells);
     and the backward of the tracker's two kernels (``MemoryReadout``,
     ``DecodeTail``: the kernel's forward, the gradient of the dense readout and
     of the un-packed tail) at the tracker trainer's shapes and the app's frame,
     against the same Functions on the port's CPU path and float64 on the card,
     within derived limits (``readout_grad_limits``, ``tail_grad_limit_rel``);
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
     run; then the bf16 serving configuration: ``YOLO(dtype=bfloat16).predict``
     (its masks through ``proto_decode_bf16``) and the pipeline with a bf16
     detector and a bf16 B3, each held to the fp32 run; the bench's fused
     seg+track step (``python -m yolo_puncture_tpu_torch.bench``: B 128 of
     720×1280, bf16 YOLOv10-S seg, the bf16 tracker at 480×864, window 4) for 5
     timed steps, whose line it prints; the tracker-quality protocol
     (``track/quality.py``, fp32, bf16 and the int8 ring) against the JAX package's
     0.662, 0.662 and 0.663;
     the tracking app ``apps/track_video.py`` (3i: its ``parse_args``,
     ``make_config``, ``build_models`` and ``track`` on 20 seeded 720×1280 frames
     of a moving bar, the tracker at 480×864 with the needle checkpoint,
     YOLOv10-S seg at 640² with retina masks and a calibration sidecar that makes
     the seeded head detect at the app's conf 0.9: online, semi-online with both
     alignments, ``--batch_propagation``, ``--amp``; each also with a bar detector
     whose tracked masks must cover the bar; per-frame times fp32 and ``--amp``),
     ``auto_speed_calc``'s pipeline with its output line (3j), and the C++ host
     geometry against its numpy versions on the pipeline's masks (3k); the
     HTTP server ``apps/serve.py`` (3l: ``Server`` over the fp32 YOLOv10-S on
     127.0.0.1, 32 PNG uploads of seeded 720×1280 frames from 16 client
     threads, retina and not, ``max_polygon`` -1/0/2, each response held to a
     direct ``predict`` of its frame, ``/stats`` showing a mean batch above 1,
     garbage refused with 400, a JPEG answered through cv2 where cv2 is
     installed and refused with 400 without it (cv2 blocked for that request),
     request latency and requests/s); ``yolo_cli predict`` over a directory of PNG files, its lines
     held to a direct ``predict`` (3m); the app's ``yolo_inference`` in image
     mode (the seeded YOLO11n seg at 640², retina) and its video mode on the
     67 needle frames (``annotate_video``: YOLO11n, B3 and U2NETP on 380²
     crops, ``device_batch=8``), whose start, end and speed must be the
     pipeline's own, with frames/s and U²-Net's share (3n); the web UI's
     ``/analyze`` in image mode with a multipart PNG, its info and PNG pixels
     held to 3n's (3o); the bench with ``--shared`` (the tracker reads the
     detector's pyramid) and without, in turns, both lines printed (3p);
     training (3q–3s): ``PropagationTrainer`` as ``apps/train_tracker.py`` builds
     it with its defaults (256², clips of 4 frames, 4 objects, batch 8, a ring of 4
     written every frame, long-term off, ``--clips mixed``, seeded init): one
     step's loss and gradients against the port's CPU run of the same batch (the
     readout and the tail launched once a frame, forward), then 20 timed steps
     and 10 with ``window_mix`` 0.5 (window 3); the detector's ``Trainer`` on
     YOLOv10-S seg at 640² and a synthetic batch of polygons: one step's losses
     and gradients at B 2 against the CPU, then 10 timed steps at B 8 (ms a step,
     images/s, peak memory); ``train_tracker --steps 20``, whose msgpack
     ``TrackerCore`` loads and steps with, and ``yolo_cli train`` for 2 steps then
     ``val`` on a synthetic PNG dataset in a temporary directory; the fine-tuners
     (3t): ``ClassifierFinetuner`` on EfficientNet-B3 at 380², batch 16, on seeded
     crops labelled by their brightness, and ``UNetFinetuner`` on U2NETP at 320²,
     batch 4, on seeded bars and their masks, each with one step's loss and
     gradients against the CPU (dropout 0), 20 timed steps (ms a step, images/s,
     peak memory; the loss must fall) and ``fit_arrays``, whose recalibrated first
     BatchNorm must equal a float64 computation; ``yolo_cli calibrate`` (3u) on the
     checkpoint of 3s over its val images (labelled with the checkpoint's own best
     boxes), held to the CPU's run, ``proto_decode`` launched, its sidecar read by
     ``YOLO.load_calibration``; ``yolo_cli export`` (3v): ``msgpack`` and ``torch``
     equal to the CPU's export, ``torch_export`` reloaded by ``torch.export.load``
     in a process that cannot import the port and run there on the card against the
     eager serving module; the bench's other modes (3w): ``--mode e2e`` (B 32 × 8,
     ``proto_decode_bf16`` once a batch, its pipeline output equal to
     ``process_frames`` of the same frames), ``--mode e2e_device``, ``--unfused``
     (the readout and tail kernels launched) and ``--long-term`` (the dense readout:
     ``memory_readout`` at 0, ``decode_tail`` launched), each line printed; video
     files (3x): the needle clip and the bar clip written as mp4 with cv2 and read
     by ``process_videos``, ``track_video``'s ``main`` and the app's video mode
     (``yolo_inference``, mp4 in and out), each held to the run on the frames
     decoded from the same file; int8 (3y): one int8 convolution at YOLOv10-S's
     shapes against its CPU run (operands equal, int32 sums equal to float64) and
     timed beside cuDNN's, ``YOLO(int8_serving=True).predict`` fp32 and bf16 with
     dynamic scales and after ``calibrate_int8`` of the needle mp4, ``serve --int8
     --calib_dir``, the tracker with the int8 ring (``memory_readout`` at 0) against
     its CPU run, and the bench's ``--int8-det``, ``--int8-det --int8-static`` and
     ``--int8-mem`` in turns with the default step, each line printed; VAN and SAM
     (3z, ``zoo_phase``): ``ClassifierNet("van_b0")`` at 380² fp32 and bf16 against the
     port's CPU run, its forward beside B3's, every VAN variant built with the JAX
     package's parameter count and b2 and b6 run, the speed pipeline with VAN-B0
     (fp32, bf16; ``proto_decode`` once a batch) with one batch's classifier held to
     the CPU, ``evaluate_speed --cls_model van_b0 --cls_init`` on the needle mp4,
     ``ClassifierFinetuner`` on VAN-B0 (B 16); SAM ``vit_b`` at 1024² (encoder and a
     64-point decoder batch against the CPU, the automatic mask generator on a
     720×1280 frame, twice, equal), ``segment_anything(frame, "vit_l")``, a ``vit_h``
     encoder pass, each encoder against its FLOP bound;
  4. run the same calls on the CPU (one frame of predict; the tracker up to its
     first window; one batch of the pipeline's device step) and compare;
  5. run the tracker with long-term memory on for 7 frames, once with the
     constructor's defaults and once with a ring of two slots so that
     consolidation fires: this readout returns the attention usage and is plain
     PyTorch, so ``memory_readout``'s count must not move;
  6. time each kernel, its plain version and a PyTorch yardstick with CUDA
     events, and ``predict``, one ``step``, one window and the pipeline's
     ``process_frames`` over the clip (frames per second, its stages) with a
     synchronised host clock, in fp32 and bf16, and the bench step's stages
     and step times with ``affinity_bf16`` on and off in turns; the backward of
     the readout and the tail at the trainer's shapes beside their forward (6h).

The line before the last is a JSON object ``{"kernels": [...]}`` with each
kernel's launches on its main path, its error against the plain version, its
times and its bound; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the package beside it, the script exits
non-zero before printing any result.  The detector's weights are a seeded
random init; the tracker's are ``resources/weights/tracker_propagation_needle.msgpack``;
the classifier's are a seeded random init too.
"""

from __future__ import annotations

import functools
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
INT8_OPS_PER_S = 1979e12   # tensor cores, dense

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
# the readout with affinity_bf16 (each logit rounded to bf16 before the softmax), kernel
# against plain version: both round bf16(s) from their own fp32 product s = q·k, which
# differ by the order of the fp32 sums (3×TF32 on the fp32 path): at most 64 products of
# 2^-21 relative error each, far under READOUT_AFF_DELTA · Σ|q_i k_i|.  A logit within
# that distance of a bf16 rounding edge may round the other way on the two sides and
# move by one step of the bf16 grid (at most two of its ulps at a power of two, times
# bf16(Ck^-0.5)), which moves its weight p by a factor expm1(step) and the row's output
# by p·expm1(step)·(|v| + |out|)/l.  The limit adds to the readout's own limit (FP32_TOL,
# or readout_bf16_limit) the smaller of the sum of those over the row's near elements and
# READOUT_AFF_SPREAD deviations of their independent sum.  The other elements round alike
# on both sides.
READOUT_AFF_DELTA = 2.0 ** -14
READOUT_AFF_SPREAD = 10.0
# (Q, M, No, valid, forced splits): the bench's window (one object pair), the tracker's
# window, one frame (the memory split over blocks)
READOUT_AFFINITY_CASES = [
    (6480, 12968, 2, "all", None),
    (6480, 12968, 2, "slots", None),
    (8100, 12968, 4, "random", None),
    (1620, 12968, 4, "all", None),
]
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

# the bf16 detector and classifier against the fp32 ones on the card, same seeded weights
# (mean absolute differences).  Rounding each layer's output to bf16 moves a unit-scale
# activation by about 2^-9; the seeded YOLOv10-S (BatchNorm statistics from seeded noise)
# damps what reaches the head, where it measured 5.5e-5 in the class scores and 0.22 px
# in the boxes over every anchor (NVIDIA H100 80GB HBM3, 700 W): the limits are about
# ten times that.  The best slot's score of a frame may come from another anchor where
# two scores nearly tie (measured 0.017 over a batch at conf 0), hence its own limit.
DET_BF16_SCORE_MEAN = 1e-3
DET_BF16_BOX_MEAN_PX = 2.0
STEP_BF16_CONF_MEAN = 0.05
CLS_BF16_PROB_MEAN = 0.05
# the tracker-quality protocol on the card against the JAX package's figures (every row)
QUALITY_TOL = 0.005
BENCH_BATCH, BENCH_ITERS = 128, 5

T_START = time.perf_counter()
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


def clocked_into(ms: dict, name: str, fn):
    """``fn``, its calls timed on the host clock with the device synchronised
    before and after, the ms added to ``ms[name]``; a model's ``dtype`` is kept."""
    def run(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn(*a, **k)
        torch.cuda.synchronize()
        ms[name] += (time.perf_counter() - t) * 1e3
        return res
    if hasattr(fn, "dtype"):
        run.dtype = fn.dtype
    return run


def predict_stage_ms(det, frames, **kw) -> dict:
    """One ``det.predict(frames, **kw)`` with the predictor's stages timed on the
    host clock, the device synchronised before and after each stage (so the
    stages do not overlap as they do in an unclocked call).  'host' is the rest:
    frame stacking, the copies to and from the card, and building the Results."""
    from yolo_puncture_tpu_torch.predict import predictor as pp

    ms = dict.fromkeys(("letterbox", "model", "select", "decode", "paste"), 0.0)
    clocked = functools.partial(clocked_into, ms)

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


def proto_decode_inputs(B, N, Hp, Wp, nm, seed, device, snap=0, dtype=torch.float32):
    """Seeded protos (B, nm, Hp, Wp) and coeffs (B, N, nm) in ``dtype``, and fp32
    boxes (B, N, 4).  Every fourth box has integer edges (the half-open test);
    ``snap`` > 0 puts every edge on a multiple of it, the boundaries of the
    kernel's pixel vectors."""
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
    return to(protos).to(dtype), to(coeffs).to(dtype), to(boxes)


# (B, N, Hp, Wp, threshold, crop, box edges snapped to multiples of[, operand type]); fp32 unless stated
BF16 = torch.bfloat16
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
    (2, 32, 160, 160, None, True, 0),     # the server's padded batches of 2, 8 and 16 (retina: no crop)
    (8, 32, 160, 160, None, False, 0),
    (16, 32, 160, 160, None, True, 0),
    (16, 32, 160, 160, None, False, 0),
    # bf16 operands and output: the bf16 detector's predict (B 4, N up to 32), the bf16
    # pipeline's launch (B 8, N 1, soft, no crop) and the bench's (B 128, N 1), then the
    # threshold and the ragged and split paths
    (4, 32, 160, 160, None, True, 0, BF16),
    (8, 1, 160, 160, None, False, 0, BF16),
    (128, 1, 160, 160, None, False, 0, BF16),
    (4, 32, 160, 160, 0.5, True, 0, BF16),
    (1, 32, 160, 160, 0.3, True, 4, BF16),
    (2, 70, 33, 45, None, True, 0, BF16),
    (3, 9, 25, 30, 0.5, False, 0, BF16),
]


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (8 significant bits); 0 at x = 0."""
    a = x.float().abs()
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a)) - 7), torch.zeros_like(a))


def check_proto_decode_case(case, device, seed=100) -> float:
    """One case of PROTO_CASES on the card, kernel against plain version.  fp32:
    soft masks within SOFT_ATOL, binary masks equal outside THRESH_BAND around the
    threshold.  bf16: soft masks within one bf16 ulp (the kernel's approximate
    sigmoid puts an fp32 value near a rounding edge on the other side), binary
    masks equal except at the pixels whose soft values differ (both sides
    compare the rounded sigmoid with the threshold rounded to bf16).  Raises
    where they disagree; returns the largest soft difference (0 for binary)."""
    from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode, proto_decode_reference

    B, N, Hp, Wp, thr, crop, snap, *typ = case
    dtype = typ[0] if typ else torch.float32
    protos, coeffs, boxes = proto_decode_inputs(B, N, Hp, Wp, 32, seed, device, snap, dtype)
    got = proto_decode(protos, coeffs, boxes, thr, crop)
    ref = proto_decode_reference(protos, coeffs, boxes, thr, crop)
    torch.cuda.synchronize()
    what = f"proto_decode B={B} N={N} {Hp}x{Wp} {str(dtype)[6:]}"
    if got.dtype != dtype or tuple(got.shape) != (B, N, Hp, Wp):
        raise AssertionError(f"proto_decode gave {got.dtype} {tuple(got.shape)}")
    if thr is None:
        diff = (got.float() - ref.float()).abs()
        err = float(diff.max())
        if dtype == torch.float32:
            ok, limit = err <= SOFT_ATOL, f"{SOFT_ATOL}"
        else:
            ulp = bf16_ulp(torch.maximum(got.float().abs(), ref.float().abs()))
            ok, limit = bool((diff <= ulp).all()), "one bf16 ulp"
            log(f"{what} soft crop={crop}: {int((diff > 0).sum())} of {diff.numel()} values differ")
        log(f"{what} soft crop={crop}: max abs diff {err:.3g} (limit {limit})")
        if not ok:
            raise AssertionError(f"soft masks differ by {err}, more than {limit}")
        return err
    soft = proto_decode_reference(protos, coeffs, boxes, None, crop)
    if dtype == torch.float32:
        excused, why = (soft - thr).abs() <= THRESH_BAND, f"within ±{THRESH_BAND:.3g} of the threshold"
    else:
        excused, why = proto_decode(protos, coeffs, boxes, None, crop) != soft, "where the soft values differ"
    bad = (got != ref) & ~excused
    n_diff, n_bad = int((got != ref).sum()), int(bad.sum())
    log(f"{what} thr={thr} crop={crop}: {n_diff} binary pixels differ, {n_bad} of them not {why}")
    if n_bad or not set(torch.unique(got.float()).tolist()) <= {0.0, 1.0}:
        raise AssertionError(f"{n_bad} binary pixels differ away from the threshold")
    return 0.0


def check_proto_decode(device) -> dict:
    """Kernel vs plain version on the card; returns the largest soft difference
    for each operand type."""
    worst = {torch.float32: 0.0, BF16: 0.0}
    for i, case in enumerate(PROTO_CASES):
        dtype = case[7] if len(case) > 7 else torch.float32
        worst[dtype] = max(worst[dtype], check_proto_decode_case(case, device, 100 + i))
    return worst


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
    that the first valid element lies in the last tile), 'slots' (every other
    run of 1620 elements, a ring slot at 480×864, so that tiles straddle an edge)
    or 'ring' (the first five slots of 1620: a ring that is only partly filled,
    as a tracker's is for its first 25 frames at ``mem_every`` 5).
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
            "last": np.arange(M) >= M - 3, "slots": (np.arange(M) // 1620) % 2 == 0,
            "ring": np.arange(M) < 5 * 1620}[valid]
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
    (6480, 12968, 2, "all", None),       # the bench's window: 4 frames of 30 x 54, one object pair
    (6480, 12968, 2, "slots", None),
    # the tracking app's tracker (TrackerCore's defaults at 480×864: ring 16, 8 vestigial
    # long-term slots, 8 objects, so M = 16·1620 + 8), a frame and a
    # --batch_propagation window, its ring partly filled
    (1620, 25928, 8, "ring", None),
    (8100, 25928, 8, "ring", None),
    (1620, 25928, 8, "slots", None),
    (8100, 25928, 8, "slots", None),
    (1620, 25928, 8, "last", None),
]
# the same tuples, for the fp32 kernel against a float64 readout on matched inputs
READOUT_FP64_CASES = [(96, 640, 2, "random", None), (96, 640, 2, "random", 3),
                      (1620, 12968, 4, "random", None), (8100, 12968, 4, "slots", None)]


def launch_readout(q, k, v, ok, n_split=None, affinity_bf16=False):
    """``memory_readout`` with the wrapper's own choice of memory splits or with
    ``n_split`` forced; returns (readout, splits used)."""
    from yolo_puncture_tpu_torch.ops.kernels import memory_readout as mr

    chosen = mr.split_for
    try:
        if n_split is not None:
            mr.split_for = lambda *a: n_split
        return (mr.memory_readout(q, k, v, ok, affinity_bf16=affinity_bf16),
                mr.split_for(q.shape[0], k.shape[0], q.device))
    finally:
        mr.split_for = chosen


def readout_affinity_limit(q, k, v, ok, ref, base):
    """Largest difference allowed at each element of a readout with
    ``affinity_bf16`` against its plain version ``ref``: ``base`` (the readout's
    own limit) plus what logits near a bf16 rounding edge may add (see
    READOUT_AFF_DELTA and the lines above it)."""
    from yolo_puncture_tpu_torch.ops.kernels.memory_readout import readout_logits

    qf, kf = q.float(), k.float()
    s = torch.matmul(qf, kf.T)
    delta = READOUT_AFF_DELTA * torch.matmul(qf.abs(), kf.abs().T)
    near = ((s - delta).bfloat16() != (s + delta).bfloat16()) & ok[None, :]
    del delta
    logits = readout_logits(q, k, affinity_bf16=True).masked_fill(~ok[None, :], float("-inf"))
    m = logits.max(dim=-1, keepdim=True).values
    p = torch.exp(logits - torch.where(torch.isfinite(m), m, torch.zeros_like(m))) * ok[None, :]
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    del logits
    step = 2.0 * bf16_ulp(s) * float(torch.tensor(q.shape[-1] ** -0.5).bfloat16())
    f = torch.expm1(step) * p * near                                # (Q, M): a weight's move where it flips
    del s, step, p, near
    vf, r = v.float().abs(), ref.float().abs()
    worst = (torch.matmul(f, vf) + f.sum(dim=-1, keepdim=True)[None] * r) / l[None]
    f2 = f * f
    spread = READOUT_AFF_SPREAD * torch.sqrt(
        2.0 * torch.matmul(f2, vf * vf) + 2.0 * f2.sum(dim=-1, keepdim=True)[None] * r * r) / l[None]
    return base + torch.minimum(worst, spread)


def check_readout_affinity_case(case, dtype, scale, device, seed=400) -> float:
    """One case of READOUT_AFFINITY_CASES on the card: the kernel with
    ``affinity_bf16`` against the plain version with it, within
    ``readout_affinity_limit`` at every element, and nearer to it on average than
    to the plain version without it (the option acts).  Raises where either does
    not hold; returns the largest absolute difference."""
    from yolo_puncture_tpu_torch.ops.kernels.memory_readout import memory_readout_reference

    Q, M, No, valid, n_split = case
    q, k, v, ok = readout_inputs(Q, M, No, 128, dtype, seed, device, valid, scale)
    got, used = launch_readout(q, k, v, ok, n_split, affinity_bf16=True)
    ref = memory_readout_reference(q, k, v, ok, affinity_bf16=True)
    unrounded = memory_readout_reference(q, k, v, ok)
    torch.cuda.synchronize()
    if got.dtype != dtype or tuple(got.shape) != (No, Q, 128) or not torch.isfinite(got).all():
        raise AssertionError(f"memory_readout with affinity_bf16 gave {got.dtype} {tuple(got.shape)}")
    base = (torch.full_like(ref, FP32_TOL, dtype=torch.float32) if dtype == torch.float32
            else readout_bf16_limit(q, k, v, ok, ref))
    limit = readout_affinity_limit(q, k, v, ok, ref, base)
    diff = (got.float() - ref.float()).abs()
    off = float((got.float() - unrounded.float()).abs().mean())
    at = int((diff / limit).argmax())
    log(f"memory_readout affinity_bf16 Q={Q} M={M} No={No} valid={valid} scale={scale:g} splits={used} "
        f"{str(dtype)[6:]}: max abs diff {float(diff.max()):.3g}, mean {float(diff.mean()):.3g} (to the unrounded "
        f"plain version {off:.3g}); nearest its limit {float(diff.flatten()[at]):.3g} of "
        f"{float(limit.flatten()[at]):.3g}; limit median {float(limit.median()):.3g}, the base's "
        f"{float(base.median()):.3g}")
    if not bool((diff <= limit).all()):
        raise AssertionError(f"memory_readout with affinity_bf16 differs from its plain version by "
                             f"{float(diff.flatten()[at])} where the limit is {float(limit.flatten()[at])}")
    if not float(diff.mean()) < off:
        raise AssertionError("memory_readout with affinity_bf16 is no nearer the rounded plain version than "
                             "the unrounded one: the option does not act")
    return float(diff.max())


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
    the fp32 kernel vs a float64 readout, and the affinity_bf16 cases; returns the
    largest absolute difference to the plain version, by dtype and by
    ("affinity_bf16", dtype)."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, case in enumerate(READOUT_CASES):
        for dtype in worst:
            for scale in (1.0, 2.0):
                worst[dtype] = max(worst[dtype], check_readout_case(case, dtype, scale, device, 200 + i))
    for i, case in enumerate(READOUT_FP64_CASES):
        check_readout_fp64_case(case, device, 260 + i)
    for i, case in enumerate(READOUT_AFFINITY_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            for scale in (1.0, 2.0):
                key = ("affinity_bf16", dtype)
                worst[key] = max(worst.get(key, 0.0), check_readout_affinity_case(case, dtype, scale, device, 400 + i))
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
    return net.to(device).eval().requires_grad_(False)   # the kernels' forward; check_tail_grad_case turns it on


def tail_inputs(N, No, H16, W16, dtype, seed, device):
    """Seeded hidden (N, No, H16, W16, 128), f8p (N, H8, W8, 64), f4p (N, H4, W4, 64)."""
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)  # noqa: E731
    return (to(rng.standard_normal((N, No, H16, W16, 128))),
            to(0.5 * rng.standard_normal((N, 2 * H16, 2 * W16, 64))),
            to(0.5 * rng.standard_normal((N, 4 * H16, 4 * W16, 64))))


# (N, No, H16, W16): the window, one frame, then shapes that leave the kernel's 32 x 8
# pixel tiles ragged in both stages, down to a single pixel, the bench's batch, and the
# tracking app's frame and --batch_propagation window with its 8 objects
TAIL_CASES = [(5, 4, 30, 54), (1, 4, 30, 54), (2, 3, 5, 7), (3, 1, 1, 1), (2, 1, 7, 9), (1, 3, 17, 33),
              (128, 2, 30, 54),   # the bench's launch: 128 frames x 2 objects, 256 cells
              (1, 8, 30, 54), (5, 8, 30, 54)]
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
    with torch.no_grad():                                   # the forward alone: check_tail_grad_case has the backward
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
    clocked = functools.partial(clocked_into, ms)

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
        clocked = functools.partial(clocked_into, ms)

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


def head_bf16_vs_fp32(det32, det16, frames, imgsz) -> dict:
    """The detector head's outputs in bf16 against fp32 for the same frames on the
    card: mean absolute differences over every anchor of the class scores and the
    boxes (px at imgsz), and of the bf16 prototypes and coefficients."""
    from yolo_puncture_tpu_torch.ops.letterbox import letterbox

    x = torch.from_numpy(frames).to(det32.device)
    with torch.no_grad():
        o32 = det32.model(letterbox(x, imgsz, bgr_to_rgb=True)[0])
        o16 = det16.model(letterbox(x, imgsz, bgr_to_rgb=True, dtype=torch.bfloat16)[0])
    if not (o16["probs"].dtype == o16["boxes"].dtype == torch.float32 and o16["proto"].dtype == torch.bfloat16):
        raise AssertionError("the bf16 head must give fp32 boxes and scores and bf16 prototypes")
    return {k: float((o16[k].float() - o32[k].float()).abs().mean()) for k in ("probs", "boxes", "coeffs", "proto")}


def bench_stage_ms(model, tracker, frames, imgsz) -> dict:
    """One fused bench step (``yolo_puncture_tpu_torch.bench.make_fused_step``
    over ``bench_models``' detector and tracker)
    with its stages timed on the host clock, the device synchronised before and
    after each: the detector's letterbox, model, select and decode; the tracker's
    resize, key encoder, readout (32 windows), head and sensory GRU, ring writes,
    decode tail, logits upsample and aggregation.  'rest' is what remains: the
    skip projections, the memory bank's concatenation, the argmax, the checksum."""
    import yolo_puncture_tpu_torch.bench as bm
    import yolo_puncture_tpu_torch.track as trk
    import yolo_puncture_tpu_torch.track.core as tc

    ms = dict.fromkeys(("letterbox", "model", "select", "decode", "resize", "encode", "readout", "head_sensory",
                        "write", "decode_tail", "upsample", "aggregate"), 0.0)
    clocked = functools.partial(clocked_into, ms)

    mem, track_fn = tracker
    net = track_fn.core.net
    mod_attrs = {(bm, "letterbox"): "letterbox", (bm, "select_detections"): "select", (bm, "decode_masks"): "decode",
                 (trk, "resize_bilinear"): "resize", (tc, "memory_readout_kernel"): "readout",
                 (tc, "upsample_bilinear_matmul"): "upsample", (tc, "soft_aggregate"): "aggregate"}
    saved = {key: getattr(*key) for key in mod_attrs}
    net_attrs = {"encode_key": "encode", "update_sensory": "head_sensory", "encode_value": "write"}
    try:
        for (mod, attr), stage in mod_attrs.items():
            setattr(mod, attr, clocked(stage, saved[(mod, attr)]))
        for attr, stage in net_attrs.items():
            setattr(net, attr, clocked(stage, getattr(net, attr)))
        net.decoder.head = clocked("head_sensory", net.decoder.head)
        net.decoder.decode_tail = clocked("decode_tail", net.decoder.decode_tail)
        step = bm.make_fused_step(clocked("model", model), track_fn, imgsz)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(mem, frames, bm.CONF, torch.zeros((), device=frames.device))
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
        for attr in net_attrs:
            delattr(net, attr)
        del net.decoder.head, net.decoder.decode_tail
    ms["rest"] = total - sum(ms.values())
    ms["total"] = total
    return ms


def bench_steps_ms(model, tracker, frames, imgsz, iters: int = 4) -> list:
    """``iters`` fused bench steps back to back with no clock between them, each
    timed with CUDA events as ``run_bench`` times them; returns their ms."""
    import yolo_puncture_tpu_torch.bench as bm

    mem, track_fn = tracker
    step = bm.make_fused_step(model, track_fn, imgsz)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    chk = torch.zeros((), device=frames.device)
    torch.cuda.synchronize()
    for i in range(iters):
        marks[i].record()
        out, mem = step(mem, frames, bm.CONF, chk)
        chk = out["chk"]
    marks[iters].record()
    torch.cuda.synchronize()
    return [marks[i].elapsed_time(marks[i + 1]) for i in range(iters)]


def proto_decode_bf16_times(Bt, N, Hp, Wp, crop, device, seed=21) -> dict:
    """``proto_decode_bf16`` at one launch shape: the bare launch, the plain
    version and ``torch.matmul`` of the bare product in bf16, in turns (200
    launches, 5 repeats), and the launch and the matmul replayed from CUDA graphs.
    Returns the sorted times and the bytes and operations of the work."""
    from yolo_puncture_tpu_torch.ops.kernels.proto_decode import kernel_args, kernel_fn, proto_decode_reference

    protos, coeffs, boxes = proto_decode_inputs(Bt, N, Hp, Wp, 32, seed, device, dtype=torch.bfloat16)
    out = torch.empty((Bt, N, Hp, Wp), dtype=torch.bfloat16, device=device)
    launch, pflat = kernel_fn(torch.bfloat16), protos.reshape(Bt, 32, Hp * Wp)
    args = kernel_args(protos, coeffs, boxes, out, None, crop)
    fns = {"kernel": lambda: launch(*args),
           "plain": lambda: proto_decode_reference(protos, coeffs, boxes, None, crop),
           "matmul": lambda: torch.matmul(coeffs, pflat)}
    times = interleaved_times_ms(fns)

    def raw():
        a = kernel_args(protos, coeffs, boxes, out, None, crop)   # binds the current stream
        return lambda: launch(*a)

    graph = {"kernel": sorted(graph_time_ms(raw) for _ in range(5)),
             "matmul": sorted(graph_time_ms(lambda: fns["matmul"]) for _ in range(5))}
    P = Hp * Wp
    bytes_moved = 2 * (Bt * 32 * P + Bt * N * 32 + Bt * N * P) + 4 * Bt * N * 4
    return {"times": times, "graph": graph, "bytes": bytes_moved, "flops": 2 * Bt * N * P * 32}


# the tracking app (``apps/track_video.py``) at full width: a clip of a bright bar moving over
# noise at 720p, the tracker at 480×864 with the needle checkpoint; the tracked mask of the
# bar detector's run must cover the bar with an IoU of at least TV_BAR_IOU on every frame
TV_FRAMES = 20
TV_BAR_IOU = 0.5


class _AppResult:
    """The part of ``Results`` that ``apps/track_video.py auto_segment`` reads."""

    def __init__(self, masks, conf):
        self.masks = type("Masks", (), {"data": masks, "__len__": lambda s: len(masks)})() if masks else None
        self.boxes = type("Boxes", (), {"conf": np.asarray(conf, np.float32),
                                        "cls": np.zeros(len(conf), np.int64)})()


class BarDetector:
    """``YOLO.predict``'s surface for the tracking app: one instance, the pixels
    brighter than 200 of the frame it is handed, as a float {0, 1} retina mask at
    that frame's size, with score 0.95.  It stands in for a detector that finds the
    bar, which seeded weights do not, so that the tracker's masks can be held to
    the bar."""

    def predict(self, image_bgr, **kw):
        m = (np.asarray(image_bgr).max(-1) > 200).astype(np.float32)
        return [_AppResult([m], [0.95]) if m.any() else _AppResult([], [])]


class TimedDetector:
    """A detector whose ``predict`` calls are timed on the host clock (they
    return numpy arrays, so each ends synchronised)."""

    def __init__(self, det):
        self.det, self.ms, self.calls = det, 0.0, 0

    def predict(self, *a, **kw):
        t = time.perf_counter()
        out = self.det.predict(*a, **kw)
        self.ms += (time.perf_counter() - t) * 1e3
        self.calls += 1
        return out


def app_calibration(model_dir, frames_rgb, min_side, imgsz) -> tuple:
    """Writes ``model_dir/calibration.json`` so that the tracking app's fixed
    ``conf=0.9`` reads, for the seeded YOLOv10-S seg, as the middle of the widest
    gap between the clip's best raw scores among the lowest quarter of them: at
    least three quarters of the frames detect (the app runs the detector on only
    some frames), and no score lies near the threshold.  A frame's best score
    counts only detections whose retina mask keeps twice the app's
    ``MIN_AREA_THRESHOLD`` of 100 pixels at the frame's size, and the frames are
    those that ``auto_segment`` hands the detector.  Platt a = 1,
    b = logit(0.9) − logit(middle).  Returns (middle, the gap)."""
    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.ops.resize import resize_linear_u8

    h, w = frames_rgb[0].shape[:2]
    scale = min_side / min(h, w)
    size = (int(h * scale), int(w * scale))
    min_px = 2 * 100 / (1.0 / scale) ** 2            # the mask is resized to the frame before its area is taken
    det = YOLO("yolo10s-seg", nc=1, seed=0)
    best = []
    for i in range(0, len(frames_rgb), 4):
        bgr = [resize_linear_u8(torch.from_numpy(f), size).numpy()[..., ::-1].copy() for f in frames_rgb[i:i + 4]]
        for r in det.predict(bgr, conf=0.0, imgsz=imgsz, retina_masks=True):
            big = r.masks.data.reshape(len(r.masks.data), -1).sum(1) >= min_px
            conf = np.asarray(r.boxes.conf)[:len(big)][big]
            best.append(float(conf.max()) if len(conf) else 0.0)
    best = np.sort(best)
    i = int(np.argmax(np.diff(best)[:max(len(best) // 4, 1)]))
    mid = float((best[i] + best[i + 1]) / 2)
    if not mid > 0:
        raise AssertionError(f"too few frames have a detection with a mask of {min_px:.0f} pixels: {best}")
    logit = lambda p: float(np.log(p / (1.0 - p)))  # noqa: E731
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "calibration.json"), "w") as f:
        json.dump({"a": 1.0, "b": logit(0.9) - logit(mid)}, f)
    return mid, float(best[i + 1] - best[i])


def run_track_app(argv, frames_rgb, detector=None, device=None) -> dict:
    """The tracking app as its ``main`` runs it, on decoded frames: ``parse_args``,
    ``make_config``, ``build_models`` and ``track`` over (frame, name) pairs, with
    ``detector`` in place of the app's YOLO if given (the YOLO is built all the
    same).  Returns the app's pieces, the per-frame argmax id maps at the
    tracker's size, and host-clock ms: the whole run, the detector's calls, the
    saver's."""
    from yolo_puncture_tpu_torch.apps import track_video as tv
    from yolo_puncture_tpu_torch.track import ResultSaver

    ids, saver_ms = {}, [0.0]

    class RecordingSaver(ResultSaver):
        def save_mask(self, prob, frame_name, *a, **kw):
            t = time.perf_counter()
            super().save_mask(prob, frame_name, *a, **kw)
            saver_ms[0] += (time.perf_counter() - t) * 1e3
            ids[frame_name] = np.argmax(prob, axis=0)

    args = tv.parse_args(argv)
    cfg = tv.make_config(args, len(frames_rgb))
    yolo, tracker = tv.build_models(args, cfg, frames_rgb[0].shape[:2], device)
    det = TimedDetector(detector or yolo)
    saver = RecordingSaver(args.output, cfg["video_name"], object_manager=tracker.object_manager)
    pairs = [(f, f"{i:05d}.jpg") for i, f in enumerate(frames_rgb)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    tv.track(args, tracker, det, pairs, saver)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    with open(os.path.join(args.output, "pred.json")) as f:
        pred = json.load(f)
    pngs = sorted(os.listdir(os.path.join(args.output, "Annotations", cfg["video_name"])))
    if len(pred["annotations"]) != len(frames_rgb) or pngs != [f"{i:05d}.png" for i in range(len(frames_rgb))]:
        raise AssertionError(f"track_video wrote {len(pred['annotations'])} annotations and {len(pngs)} PNGs "
                             f"for {len(frames_rgb)} frames")
    return {"args": args, "cfg": cfg, "tracker": tracker, "pred": pred, "ids": [ids[n] for _, n in pairs],
            "ms": ms, "detector_ms": det.ms, "detector_calls": det.calls, "saver_ms": saver_ms[0]}


def app_geometry(records) -> dict:
    """The pipeline's host geometry over the detected frames' letterbox masks
    (``records`` from ``VideoSpeedPipeline._run``): the polygon and the length
    from the C++ tracer and calipers (what ``mask_to_polygons`` and
    ``min_rect_len`` take without cv2) against the numpy versions: polygons equal,
    lengths within 1e-9 relative (or, where two hull edges tie, rectangles of
    equal area).  Returns the per-frame host ms of each, medians of 3 passes."""
    from yolo_puncture_tpu_torch import native
    from yolo_puncture_tpu_torch.ops import geometry as geo

    items = [(r["mask_lb"], r["pad"], r["ratio"]) for r in records if bool(r["valid"])]
    if not items:
        raise AssertionError("no detected frame to measure the host geometry on")

    def length(poly, pad, r, rect):
        if len(poly) == 0:
            return 0.0, 0.0
        pts = np.asarray((poly - pad) / r, dtype=np.int32).reshape(-1, 2)
        if len(pts) < 3:
            return 0.0, 0.0
        (_, (w, h), _) = rect(pts.astype(np.float64))
        return max(w, h), w * h

    def numpy_pass():
        out = []
        for m, pad, r in items:
            polys = geo._trace_contours_np(m)
            poly = max(polys, key=len) if polys else np.zeros((0, 2), np.float32)
            out.append((poly, length(poly, pad, r, geo._min_area_rect_np)))
        return out

    def native_pass():
        out = []
        for m, pad, r in items:
            polys = native.trace_contours(m, largest_only=True)
            poly = polys[0] if polys else np.zeros((0, 2), np.float32)
            out.append((poly, length(poly, pad, r, native.min_area_rect)))
        return out

    times = {"numpy": [], "native": []}
    for _ in range(3):
        for name, fn in (("numpy", numpy_pass), ("native", native_pass)):
            t = time.perf_counter()
            res = fn()
            times[name].append((time.perf_counter() - t) * 1e3 / len(items))
            if name == "numpy":
                ref = res
            else:
                got = res
    for (gp, (gl, ga)), (rp, (rl, ra)) in zip(got, ref):
        if not np.array_equal(gp, rp):
            raise AssertionError("the C++ tracer's polygon differs from the numpy tracer's")
        if not (abs(gl - rl) <= 1e-9 * max(rl, 1.0) or abs(ga - ra) <= 1e-9 * max(ra, 1.0)):
            raise AssertionError(f"the C++ calipers give {gl} (area {ga}), numpy {rl} (area {ra})")
    return {"frames": len(items), "numpy_ms_per_frame": sorted(times["numpy"])[1],
            "native_ms_per_frame": sorted(times["native"])[1],
            "points": int(np.median([len(p) for p, _ in got]))}


# the server, the CLI, the app and the web UI (phases 3l-3p)
SERVE_FRAMES, SERVE_CLIENTS = 32, 16
# one serve response against a direct predict of its frame: the server runs the frame in a
# padded batch of up to 16, where cuDNN may sum in another order than at batch 1, so a box
# or score may round one step the other way and a mask pixel at the threshold may flip
SERVE_BOX_TOL, SERVE_CONF_TOL, SERVE_POLY_AREA_AGREE = 0.01 + 1e-5, 1e-4 + 1e-7, 0.999


def http_post(url: str, data: bytes, ctype: str, timeout: float = 600.0):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, method="POST", headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_get(url: str, timeout: float = 60.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.headers["Content-Type"], resp.read()


def same_serve_json(got: dict, ref: dict, hw) -> bool:
    """A serve response against the JSON of a direct predict (its ``batch``
    aside): cls and the polygon count equal, boxes and scores within one step of
    their rounding, each polygon equal or, where a mask pixel went the other
    way, filled to nearly the same pixels.  Returns whether all was equal."""
    from yolo_puncture_tpu_torch.ops.geometry import polygon_to_mask

    if got.get("error") is not None or got["cls"] != ref["cls"] or len(got["boxes"]) != len(ref["boxes"]):
        raise AssertionError(f"serve response {got} differs from the direct predict {ref}")
    if ref["boxes"] and not (np.abs(np.subtract(got["boxes"], ref["boxes"])).max() <= SERVE_BOX_TOL and
                             np.abs(np.subtract(got["conf"], ref["conf"])).max() <= SERVE_CONF_TOL):
        raise AssertionError(f"serve boxes or scores differ from the direct predict: {got} vs {ref}")
    if len(got["polygons"]) != len(ref["polygons"]):
        raise AssertionError("serve polygon count differs from the direct predict")
    for g, r in zip(got["polygons"], ref["polygons"]):
        if g != r:
            fg, fr = polygon_to_mask(hw, g, 1), polygon_to_mask(hw, r, 1)
            if (fg == fr).mean() < SERVE_POLY_AREA_AGREE:
                raise AssertionError("a serve polygon differs from the direct predict's")
    return got["boxes"] == ref["boxes"] and got["conf"] == ref["conf"] and got["polygons"] == ref["polygons"]


def drive_server(server, pngs, queries):
    """``len(pngs)`` POSTs to the running server from SERVE_CLIENTS threads at
    once (client k sends requests k, k + SERVE_CLIENTS, ...).  Returns the
    responses and each request's latency in ms."""
    import threading

    base = f"http://127.0.0.1:{server.port}/predict"
    out, lat = [None] * len(pngs), [0.0] * len(pngs)

    def client(k):
        for i in range(k, len(pngs), SERVE_CLIENTS):
            t = time.perf_counter()
            out[i] = http_post(base + queries[i], pngs[i], "image/png")
            lat[i] = (time.perf_counter() - t) * 1e3

    threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError("a serve client did not finish")
    return out, lat


class TimedUNet:
    """U²-Net's ``predict`` with its calls timed on the host clock (each returns
    a numpy mask, so each ends synchronised)."""

    def __init__(self, unet):
        self.unet, self.ms, self.calls = unet, 0.0, 0

    def predict(self, image):
        t = time.perf_counter()
        out = self.unet.predict(image)
        self.ms += (time.perf_counter() - t) * 1e3
        self.calls += 1
        return out


def multipart(fields: dict, filename: str, payload: bytes):
    boundary = "chipsmokeboundary"
    parts = []
    for k, v in fields.items():
        parts += [f"--{boundary}".encode(), f'Content-Disposition: form-data; name="{k}"'.encode(), b"",
                  str(v).encode()]
    parts += [f"--{boundary}".encode(), f'Content-Disposition: form-data; name="file"; filename="{filename}"'.encode(),
              b"Content-Type: image/png", b"", payload, f"--{boundary}--".encode(), b""]
    return b"\r\n".join(parts), f"multipart/form-data; boundary={boundary}"


# ---------------------------------------------------------------------------
# training: the backward of the tracker's kernels, the tracker's and the detector's trainers
# ---------------------------------------------------------------------------

FP32_UNIT = 2.0 ** -24
# (Q, M, No, valid): the tracker trainer's readout (a 256×256 frame, a ring of 4 × 256 written
# every frame and the 8 vestigial long-term slots; full, and half filled as in a clip's first
# frames), and the tracking app's frame at 480×864 (ring of 8, every 5 frames)
READOUT_GRAD_CASES = [(256, 1032, 4, "train_full"), (256, 1032, 4, "train_half"), (1620, 12968, 4, "ring")]
# (N, No, H16, W16): one frame and a window of 3 frames of the trainer (16×16 → 64×64), the app's frame
TAIL_GRAD_CASES = [(1, 4, 16, 16), (3, 4, 16, 16), (1, 4, 30, 54)]
# the detector trainer on the card against its CPU run, fp32 both: the components of the loss and
# each gradient tensor.  Two fp32 implementations of the same train-mode network (BatchNorm on
# batch statistics) differ by up to 1e-5 in the components and 2.3e-4 in a gradient tensor on the
# CPU (tests/test_torch_train_detector.py, YOLOv8-n at 64²); the limits give that ten times, and
# the global term is for BatchNorm biases before a train-mode BatchNorm, whose gradient vanishes
# but for rounding
DET_STEP_LOSS_REL = 1e-4
DET_STEP_GRAD_REL, DET_STEP_GRAD_GLOBAL = 2.3e-3, 1e-5
# the tracker trainer on the card against its CPU run: the loss, and each parameter's gradient
# ‖Δg‖ ≤ rel·‖g‖ + global·‖all of g‖; the CPU test of the port against JAX measured 2.6e-5 per
# tensor over a clip of 4 frames, the limit gives ten times that over the batch's 8 clips
TRACK_STEP_LOSS_REL = 1e-5
TRACK_STEP_GRAD_REL, TRACK_STEP_GRAD_GLOBAL = 1e-3, 1e-5


def readout_grad_inputs(case, device, seed):
    Q, M, No, valid = case
    q, k, v, _ = readout_inputs(Q, M, No, 128, torch.float32, seed, device)
    ring = 1024 if valid == "train_full" else 512 if valid == "train_half" else 8 * 1620
    ok = (torch.arange(M, device=device) < ring)
    d_out = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((No, Q, 128)).astype(np.float32))
    return q, k, v, ok, d_out.to(device)


def readout_grads(q, k, v, ok, d_out):
    """(output, dq, dk, dv) of ``memory_readout`` through its autograd Function."""
    from yolo_puncture_tpu_torch.ops.kernels.memory_readout import memory_readout

    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = memory_readout(q, k, v, ok)
    if out.grad_fn is None:
        raise AssertionError("memory_readout returned a tensor without grad_fn for inputs that require one")
    out.backward(d_out)
    return out.detach(), q.grad, k.grad, v.grad


def readout_grads_fp64(q, k, v, ok, d_out):
    """The dense readout's gradients in float64 by autograd, on the inputs' device."""
    q, k, v = (t.detach().double().requires_grad_() for t in (q, k, v))
    s = (q @ k.T) * q.shape[1] ** -0.5
    s = s.masked_fill(~ok[None], float("-inf"))
    m = s.max(-1, keepdim=True).values
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m))) * ok[None]
    out = torch.einsum("qm,nmc->nqc", p / p.sum(-1, keepdim=True).clamp_min(1e-9), v)
    out.backward(d_out.double())
    return out.detach(), q.grad, k.grad, v.grad


def readout_grad_limits(q, k, v, ok, d_out, out_err):
    """Per-element limits for (dq, dk, dv) of two fp32 runs of the backward against
    each other: the worst-case bound of fp32 sums taken in another order, n·2^-24
    times the sum of the magnitudes of the terms (n = M + No·Cv for dq and dk, which
    go through dP = Σ_o dO·Vᵀ and a product over the memory, n = Q for dv), plus
    the recomputed weights P, whose fp32 logits may differ by Ck·2^-24·Σ|q_i k_i|·Ck^-0.5
    (a relative difference of P of twice that), plus the forward's difference
    ``out_err`` (max |ΔO|), which δ = Σ dO·O carries into dS."""
    from yolo_puncture_tpu_torch.ops.kernels.memory_readout import readout_weights

    Q, Ck = q.shape
    No, M, Cv = v.shape
    scale = Ck ** -0.5
    qa, ka, va, da = q.abs(), k.abs(), v.abs(), d_out.abs()
    P = readout_weights(q, k, ok)
    out = torch.einsum("qm,nmc->nqc", P, v)
    delta_mag = (da * out.abs()).sum(dim=(0, 2))                                    # (Q,)
    dS_mag = P * (torch.einsum("nqc,nmc->qm", da, va) + delta_mag[:, None])
    logit_err = Ck * FP32_UNIT * float(((qa @ ka.T) * ok[None]).max()) * scale
    rel = (M + No * Cv) * FP32_UNIT + 2.0 * logit_err
    d_delta = da.sum(dim=(0, 2)) * out_err                                          # (Q,) bound of Δδ
    lq = rel * (dS_mag @ ka) * scale + d_delta[:, None] * (P @ ka) * scale
    lk = rel * (dS_mag.T @ qa) * scale + (P * d_delta[:, None]).T @ qa * scale
    lv = (Q * FP32_UNIT + 2.0 * logit_err) * torch.einsum("qm,nqc->nmc", P, da)
    return lq, lk, lv


def check_readout_grad_case(case, device, seed=500) -> float:
    """The readout's backward on the card (kernel forward, ``MemoryReadout``'s
    backward) against the same Function on the port's CPU path and against a
    float64 autograd readout on the card, within ``readout_grad_limits``; rows with
    no valid element get zeros.  Returns the largest difference to the CPU run
    relative to the limit."""
    q, k, v, ok, d_out = readout_grad_inputs(case, device, seed)
    out, *grads = readout_grads(q, k, v, ok, d_out)
    cpu_out, *cpu = readout_grads(q.cpu(), k.cpu(), v.cpu(), ok.cpu(), d_out.cpu())
    ref_out, *ref = readout_grads_fp64(q, k, v, ok, d_out)
    out_err = float((out - cpu_out.to(device)).abs().max())
    limits = readout_grad_limits(q, k, v, ok, d_out, max(out_err, float((out.double() - ref_out).abs().max())))
    worst = 0.0
    parts = []
    for name, g, c, r, lim in zip(("dq", "dk", "dv"), grads, cpu, ref, limits):
        if not torch.isfinite(g).all():
            raise AssertionError(f"memory_readout backward: {name} is not finite")
        d_cpu = (g - c.to(device)).abs()
        d_ref = (g.double() - r).abs()
        # an invalid element's gradient and its limit are both 0
        share = max(float(torch.where(lim > 0, d / lim, d * float("inf")).nan_to_num(0.0).max())
                    for d in (d_cpu.double(), d_ref))
        worst = max(worst, share)
        parts.append(f"{name} max abs diff {float(d_cpu.max()):.3g} to the CPU, {float(d_ref.max()):.3g} to float64 "
                     f"(|g| up to {float(r.abs().max()):.3g}; at most {share:.3g} of the limit)")
        if not (bool((d_cpu <= lim).all()) and bool((d_ref <= lim).all())):
            raise AssertionError(f"memory_readout backward {case}: {name} outside its limit ({share:.3g} of it)")
    log(f"memory_readout backward Q={case[0]} M={case[1]} No={case[2]} valid={case[3]} "
        f"({int(ok.sum())} valid): forward diff to the CPU {out_err:.3g}; " + "; ".join(parts))
    return worst


def tail_grad_limit_rel(N, No, H16, W16) -> float:
    """Per-tensor limit of the tail's gradients, two fp32 runs against each other:
    n·2^-24 of the gradient's norm, n the longest chain of sums from the logits'
    cotangent to a gradient: a weight's gradient sums over every pixel of every
    cell at stride 8 (N·No·H8·W8), after the 3×3 × 64 products back through dec4
    and the head's 64."""
    return (N * No * 4 * H16 * W16 + 9 * 64 + 64 + 9 * 128) * FP32_UNIT


def check_tail_grad_case(net, case, device, seed=520) -> float:
    """The tail's backward on the card (kernel forward, ``DecodeTail``'s backward:
    the un-packed tail's vector-Jacobian product) against the same on the port's
    CPU path and against a float64 run of the un-packed tail on the card, each
    gradient (hidden, f8p, f4p and the eight raw weights) within
    ``tail_grad_limit_rel`` of its norm.  Returns the largest relative difference."""
    import copy

    from yolo_puncture_tpu_torch.ops.kernels import decode_tail as dt

    N, No, H16, W16 = case
    hidden, f8p, f4p = tail_inputs(N, No, H16, W16, torch.float32, seed, device)
    d_out = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((N, No, 4 * H16, 4 * W16))
                             .astype(np.float32)).to(device)

    def run(dec, dev, dtype=torch.float32):
        x = [t.detach().to(dev, dtype).requires_grad_() for t in (hidden, f8p, f4p)]
        dec.zero_grad(set_to_none=True)
        params = dec.tail_params(torch.float32)
        if dtype == torch.float64:
            out = dt.decode_tail_unpacked(params.raw, *x)
        else:
            out = dt.decode_tail(params, *x)
            if out.grad_fn is None:
                raise AssertionError("decode_tail returned a tensor without grad_fn for inputs that require one")
        out.backward(d_out.to(dev, dtype))
        names = [n for n in dt.RAW_FIELDS if "running" not in n]
        params = dict(dec.named_parameters())
        return [t.grad for t in x] + [params[n].grad for n in names], ["hidden", "f8p", "f4p"] + names

    dec = net.decoder
    dec.requires_grad_(True)
    got, names = run(dec, device)
    cpu, _ = run(copy.deepcopy(dec).cpu(), "cpu")
    ref, _ = run(copy.deepcopy(dec).double(), device, torch.float64)
    dec.requires_grad_(False)
    rel = tail_grad_limit_rel(*case)
    worst, parts = 0.0, []
    for name, g, c, r in zip(names, got, cpu, ref):
        if g is None or not torch.isfinite(g).all():
            raise AssertionError(f"decode_tail backward: no finite gradient for {name}")
        e_cpu = float((g - c.to(device)).norm() / c.norm())
        e_ref = float((g.double() - r).norm() / r.norm())
        worst = max(worst, e_cpu, e_ref)
        parts.append(f"{name} {e_cpu:.2g}/{e_ref:.2g}")
    log(f"decode_tail backward N={N} No={No} {H16}x{W16}: relative norm of the difference to the CPU / to float64, "
        f"per gradient: {', '.join(parts)} (limit {rel:.3g})")
    if worst > rel:
        raise AssertionError(f"decode_tail backward {case}: a gradient is {worst:.3g} from its reference (> {rel:.3g})")
    return worst


TRACKER_TRAIN_ARGS = ["--clips", "mixed"]            # apps/train_tracker.py's defaults: 256², clip 4, 4 objects, B 8
DET_TRAIN_B, DET_TRAIN_STEPS, TRACK_TRAIN_STEPS, TRACK_WINDOW_STEPS = 8, 10, 20, 10


def grads_match(params_gpu, params_cpu, rel, glob, what):
    """Each gradient within rel·‖g‖ + glob·‖all of g‖ of the CPU's; returns the worst share of the limit."""
    total = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in params_cpu)))
    worst = 0.0
    for (name, pg), pc in zip(params_gpu, params_cpu):
        err = float((pg.grad.cpu() - pc.grad).norm())
        lim = rel * float(pc.grad.norm()) + glob * total
        worst = max(worst, err / lim)
        if err > lim:
            raise AssertionError(f"{what}: the gradient of {name} is {err:.3g} from the CPU's (limit {lim:.3g})")
    return worst


def polygon_batch(B, S, seed, max_boxes=32):
    """A synthetic detector batch: B seeded images of S² with 1–4 random polygons
    each (filled brighter than the noise; radii of 15–40 % of S, since the seeded
    head's boxes span about 15 cells a level and a small object overlaps none
    enough to be assigned), their boxes and masks at S/4."""
    from yolo_puncture_tpu_torch.train.data import _rasterize

    rng = np.random.default_rng(seed)
    images = rng.integers(0, 90, (B, S, S, 3)).astype(np.float32) / 255.0
    out = {"images": images, "gt_labels": np.zeros((B, max_boxes), np.int32),
           "gt_bboxes": np.zeros((B, max_boxes, 4), np.float32), "mask_gt": np.zeros((B, max_boxes), bool),
           "gt_masks": np.zeros((B, max_boxes, S // 4, S // 4), np.float32)}
    for b in range(B):
        for i in range(int(rng.integers(1, 5))):
            c = rng.uniform(0.3 * S, 0.7 * S, 2)
            r = rng.uniform(0.15 * S, 0.4 * S)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
            poly = np.clip(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1), 0, S - 1).astype(np.float32)
            m = _rasterize(poly, S, S) > 0
            out["images"][b][m] = np.float32(200 / 255.0)
            out["gt_bboxes"][b, i] = (*poly.min(0), *poly.max(0))
            out["mask_gt"][b, i] = True
            out["gt_masks"][b, i] = _rasterize(poly / 4.0, S // 4, S // 4)
    return out


def train_tracker_phase(smi: str, steps=TRACK_TRAIN_STEPS, window_steps=TRACK_WINDOW_STEPS, argv=None,
                        device=None) -> dict:
    """3q: ``PropagationTrainer`` as ``apps/train_tracker.py`` builds it with its
    defaults (256², clips of 4, 4 objects, batch 8, a ring of 4 written every
    frame, long-term off, ``--clips mixed``, seeded init) on the card: one step's
    loss and gradients against the port's CPU run of the same batch, then timed
    steps per frame and with ``window_mix`` 0.5.  Returns the kernels' launches."""
    import copy

    from yolo_puncture_tpu_torch.apps import train_tracker as tt_app
    from yolo_puncture_tpu_torch.ops.kernels import decode_tail as dt
    from yolo_puncture_tpu_torch.ops.kernels import memory_readout as mr
    from yolo_puncture_tpu_torch.track import TrackerCore
    from yolo_puncture_tpu_torch.track import train as ttrain

    targs = tt_app.parse_args(TRACKER_TRAIN_ARGS + (argv or []))
    tcore, trainer = tt_app.build_trainer(targs, device)
    log(f"tracker trainer: {targs.height}x{targs.width}, clip_len {targs.clip_len}, {targs.max_objects} objects, "
        f"batch {targs.batch}, ring {tcore.memory.keys.shape[0]} written every frame, long-term "
        f"{tcore.enable_long_term}, clips {targs.clips}, lr {targs.lr}, seeded init")
    launches = {"memory_readout": 0, "decode_tail": 0}
    images, onehot, valid = trainer._sample_batch()
    cpu_core = TrackerCore(variables=copy.deepcopy(tcore.net).cpu().state_dict(), device="cpu",
                           image_size=tcore.image_size, max_objects=tcore.max_objects, mem_frames=4, mem_every=1,
                           enable_long_term=False)
    cpu_trainer = ttrain.PropagationTrainer(cpu_core, lr=targs.lr, clip_len=targs.clip_len, batch_size=targs.batch)
    mr.memory_readout.launches = dt.decode_tail.launches = 0
    loss_gpu = trainer.loss_and_grads(images, onehot, valid)
    torch.cuda.synchronize()
    step_launches = (mr.memory_readout.launches, dt.decode_tail.launches)
    t = time.perf_counter()
    loss_cpu = cpu_trainer.loss_and_grads(images.cpu(), onehot.cpu(), valid.cpu())
    cpu_s = time.perf_counter() - t
    share = grads_match(list(tcore.net.named_parameters()), list(cpu_core.net.parameters()), TRACK_STEP_GRAD_REL,
                        TRACK_STEP_GRAD_GLOBAL, "tracker trainer")
    log(f"main path (tracker training step, {targs.batch} clips of {targs.clip_len} frames): memory_readout launched "
        f"{step_launches[0]}, decode_tail {step_launches[1]} times; loss {loss_gpu:.6f} on the card, {loss_cpu:.6f} "
        f"on the CPU ({cpu_s:.1f} s); gradients at most {share:.3g} of their limit (rel {TRACK_STEP_GRAD_REL}, "
        f"global {TRACK_STEP_GRAD_GLOBAL})")
    if step_launches != (targs.batch * targs.clip_len,) * 2:
        raise AssertionError(f"the tracker's training step launched {step_launches}, not one readout and one tail "
                             f"a frame")
    if not (np.isfinite(loss_gpu) and abs(loss_gpu - loss_cpu) <= TRACK_STEP_LOSS_REL * abs(loss_cpu)):
        raise AssertionError(f"tracker training loss {loss_gpu} against the CPU's {loss_cpu}")
    launches["memory_readout"] += step_launches[0]
    launches["decode_tail"] += step_launches[1]
    del cpu_core, cpu_trainer
    trainer.opt.step()
    for name, mix, n in (("per-frame", 0.0, steps), ("window_mix 0.5", 0.5, window_steps)):
        trainer.window_mix = mix
        if mix and trainer.window_loss_fn is None:
            # clip_len − 1 = 3 frames after the first must fill whole windows: window 3 (the app's
            # default window of 4 needs --clip_len 5)
            trainer.window_loss_fn = ttrain.build_windowed_propagation_loss(tcore, 3)
        mr.memory_readout.launches = dt.decode_tail.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        last = trainer.fit(steps=n, log_every=0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / n
        got = (mr.memory_readout.launches / n, dt.decode_tail.launches / n)
        log(f"main path (tracker training, {name}): {n} steps, {ms:.1f} ms a step, "
            f"{targs.batch * 1e3 / ms:.1f} clips/s; launches a step (memory_readout, decode_tail) {got}; last loss "
            f"{last:.6f} [{smi}]")
        if not (np.isfinite(last) and min(got) > 0):
            raise AssertionError(f"tracker training ({name}): loss {last}, launches {got}")
        launches["memory_readout"] += mr.memory_readout.launches
        launches["decode_tail"] += dt.decode_tail.launches
    return launches


def train_detector_phase(smi: str, imgsz: int = 640, batch: int = DET_TRAIN_B, steps: int = DET_TRAIN_STEPS,
                         model: str = "yolo10s-seg", device=None) -> None:
    """3r: the detector's ``Trainer`` on YOLOv10-S seg (published widths and depth,
    one class) at 640² on a synthetic batch of polygons: one step's losses and
    gradients at B 2 against the port's CPU run, then ``steps`` timed steps at
    ``batch`` (ms a step, images/s, peak memory)."""
    import copy

    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.train import Trainer

    det_model = YOLO(model, nc=1, seed=0, device=device).model
    det_batch = polygon_batch(batch, imgsz, seed=8)
    cpu_model = copy.deepcopy(det_model).cpu()
    small = {k: v[:2] for k, v in det_batch.items()}
    gpu_tr, cpu_tr = Trainer(det_model, nc=1, imgsz=imgsz), Trainer(cpu_model, nc=1, imgsz=imgsz)
    t = time.perf_counter()
    _, l_gpu = gpu_tr.loss_and_grads(gpu_tr._to_device(gpu_tr._quantize_for_transfer(small)))
    _, l_cpu = cpu_tr.loss_and_grads(cpu_tr._to_device(cpu_tr._quantize_for_transfer(small)))
    comp = {k: (float(l_gpu[k].detach()), float(l_cpu[k].detach())) for k in l_cpu}
    share = grads_match(list(det_model.named_parameters()), list(cpu_model.parameters()), DET_STEP_GRAD_REL,
                        DET_STEP_GRAD_GLOBAL, "detector trainer")
    log(f"detector trainer {model} {imgsz}^2, B 2 against the CPU ({time.perf_counter() - t:.1f} s): losses "
        f"(card, CPU) {json.dumps(comp)}; gradients at most {share:.3g} of their limit (rel {DET_STEP_GRAD_REL}, "
        f"global {DET_STEP_GRAD_GLOBAL})")
    for k, (a, b) in comp.items():
        if not (np.isfinite(a) and abs(a - b) <= DET_STEP_LOSS_REL * abs(b) + 1e-7):
            raise AssertionError(f"detector training loss {k}: {a} on the card, {b} on the CPU")
    if comp["box"][1] <= 0 or comp["seg"][1] <= 0:
        raise AssertionError("the synthetic batch gave no positives")
    del cpu_model, cpu_tr
    state = gpu_tr.init_state()
    state, m = gpu_tr.train_step(state, det_batch)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    totals = []
    for _ in range(steps):
        state, m = gpu_tr.train_step(state, det_batch)
        totals.append(float(m["total"]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"main path (detector training, {model} {imgsz}^2, B {batch}): {steps} steps {ms:.1f} ms a step, "
        f"{batch * 1e3 / ms:.1f} images/s, peak memory {peak:.2f} GiB; totals {[round(v, 3) for v in totals]} [{smi}]")
    if not all(np.isfinite(totals)):
        raise AssertionError("detector training gave a loss that is not finite")


def train_apps_phase(tmp: str, imgsz: int = 640, device=None, tracker_argv=(), model: str = "yolo10s-seg") -> dict:
    """3s: ``train_tracker --steps 20`` writes a msgpack that ``TrackerCore`` loads
    and steps with; ``yolo_cli train`` for 2 steps, then ``val``, on a synthetic
    PNG dataset, in the directory ``tmp`` (the dataset in ``tmp/data``, the
    checkpoints in ``tmp/run``, which 3u calibrates).  Returns the kernels'
    launches."""
    import contextlib
    import importlib.util
    import io

    from yolo_puncture_tpu_torch.apps import train_tracker as tt_app
    from yolo_puncture_tpu_torch.apps import yolo_cli
    from yolo_puncture_tpu_torch.ops.kernels import decode_tail as dt
    from yolo_puncture_tpu_torch.ops.kernels import memory_readout as mr
    from yolo_puncture_tpu_torch.track import ObjectInfo, TrackerCore
    from yolo_puncture_tpu_torch.utils.png import write_png_rgb

    out = os.path.join(tmp, "tracker.msgpack")
    mr.memory_readout.launches = dt.decode_tail.launches = 0
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        iou0, iou1 = tt_app.main(TRACKER_TRAIN_ARGS + list(tracker_argv) + ["--steps", "20", "--eval_clips", "4",
                                                                              "--output", out], device=device)
    lines = buf.getvalue().splitlines()
    got = {"memory_readout": mr.memory_readout.launches, "decode_tail": dt.decode_tail.launches}
    log(f"main path (train_tracker --steps 20): {time.perf_counter() - t:.1f} s, launches {json.dumps(got)}; "
        f"lines {lines[0]!r} … {lines[-2]!r} {lines[-1]!r}")
    if min(got.values()) <= 0 or lines[-1] != f"saved {out}" or not lines[0].startswith("propagation IoU before: "):
        raise AssertionError("train_tracker did not run its kernels or print its lines")
    targs = tt_app.parse_args(TRACKER_TRAIN_ARGS + list(tracker_argv))
    loaded = TrackerCore(variables=out, image_size=(targs.height, targs.width), max_objects=targs.max_objects,
                         mem_frames=4, mem_every=1, enable_long_term=False, device=device)
    frames, masks = bar_frames(3, targs.height, targs.width, seed=9)
    loaded.incorporate_detection(frames[0], masks[0].astype(np.int32), [ObjectInfo(id=1)])
    prob = np.stack([loaded.step(f) for f in frames[1:]])
    if not np.isfinite(prob).all():
        raise AssertionError("the trained tracker's msgpack does not load and step")
    log(f"train_tracker's msgpack ({os.path.getsize(out)} bytes) loads in TrackerCore and steps; IoU before "
        f"{iou0:.3f}, after {iou1:.3f}")

    data = os.path.join(tmp, "data")
    for split, n in (("train", 4), ("val", 2)):
        os.makedirs(os.path.join(data, "images", split))
        os.makedirs(os.path.join(data, "labels", split))
        b = polygon_batch(n, 480, seed=20 + n)
        for i in range(n):
            write_png_rgb(os.path.join(data, "images", split, f"{i}.png"),
                          (b["images"][i] * 255).round().astype(np.uint8))
            with open(os.path.join(data, "labels", split, f"{i}.txt"), "w") as f:
                for x1, y1, x2, y2 in b["gt_bboxes"][i][b["mask_gt"][i]] / 480.0:
                    f.write(f"0 {x1:.5f} {y1:.5f} {x2:.5f} {y1:.5f} {x2:.5f} {y2:.5f} {x1:.5f} {y2:.5f}\n")
    run = os.path.join(tmp, "run")
    aug = [] if importlib.util.find_spec("cv2") else ["augment=false"]
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        st = yolo_cli.main(["train", f"data={data}", f"model={model}", "epochs=1", f"imgsz={imgsz}", "batch=2",
                            f"project={run}"] + aug, device=device)
        yolo_cli.main(["val", f"data={data}", f"model={run}", f"arch={model}", f"imgsz={imgsz}"], device=device)
    lines = buf.getvalue().splitlines()
    log(f"yolo_cli train (2 steps, {'augmented' if not aug else 'no augmentation: no cv2'}) then val: "
        f"{time.perf_counter() - t:.1f} s; lines {lines}")
    if st.step != 2 or lines[0] != f"training done: 2 steps; checkpoints in {run}" \
            or not lines[1].startswith("box  mAP50="):
        raise AssertionError("yolo_cli train / val did not print their lines")
    return got


# ---------------------------------------------------------------------------
# 3t-3w: the fine-tuners, yolo_cli calibrate and export, the bench's other modes
# ---------------------------------------------------------------------------

# the fine-tuners on the card against their CPU run, fp32 both: (loss rel, gradient rel, global) as
# grads_match takes them.  The classifier's are the detector trainer's (a deep train-mode network,
# BatchNorm on batch statistics, summed in another order by cuDNN and the CPU).  U2NETP's fp32 gradients
# are farther from exact: its first stages normalise inputs whose mean is far above their spread (images
# in [0, 1]), where flax's E[x²] − E[x]² in fp32 cancels.  scripts/finetune_fp32_deviation.py measured on
# the CPU, fp32 against float64 at 320², batch 4: gradients up to 1.94 % of their norm, the vanishing
# biases before a train-mode BatchNorm up to 4.1e-5 of the whole gradient, the loss 8.2e-8; the limits
# give ten times that.  VAN-B0's, by the same script: at 380², batch 16 (phase 3z; on the H100 machine's CPU)
# gradients up to 2.27e-6 of their norm, the vanishing ones up to 4.7e-8 of the whole gradient, the loss 8.2e-8;
# at 96², batch 4 (the gpu test's size) 6.9e-6, 1.2e-8 and 0; ten times the larger of each
FT_LIMITS = {"classifier": (DET_STEP_LOSS_REL, DET_STEP_GRAD_REL, DET_STEP_GRAD_GLOBAL),
             "unet": (1e-6, 0.2, 4e-4),
             "van": (8.2e-7, 6.9e-5, 4.7e-7)}
# recalibrated statistics of the first BatchNorm against float64 convolutions of the same batches: a fp32
# convolution of 27 (B3's stem) or 27 + bias (U2NETP's first) products per output rounds each by a few 2^-24
FT_STATS_REL = 1e-5
FT_STEPS = 20


def brightness_crops(n: int, size: int, seed: int):
    """n seeded RGB crops of ``size``²: noise of ±40 around a level drawn per crop,
    and a few dark blotches; label 1 where the level is above 115."""
    rng = np.random.default_rng(seed)
    level = rng.uniform(30, 200, n)
    crops = np.clip(level[:, None, None, None] + rng.uniform(-40, 40, (n, size, size, 3)), 0, 255)
    for c in crops:
        y, x = rng.integers(0, size * 3 // 4, 2)
        c[y:y + size // 4, x:x + size // 4] *= 0.3
    return crops.astype(np.uint8), (level > 115).astype(np.int32)


def bar_masks(n: int, size: int, seed: int):
    """n seeded RGB images in [0, 1] of ``size``²: dark noise with one bright bar
    each, and the bar's mask (the toy task of ``tests/test_finetune.py``)."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 0.2, (n, size, size, 3)).astype(np.float32)
    masks = np.zeros((n, size, size), np.float32)
    for i in range(n):
        y, x = rng.integers(size // 8, size // 2, 2)
        h, w = rng.integers(size // 8, size // 3, 2)
        images[i, y:y + h, x:x + w] = 0.9
        masks[i, y:y + h, x:x + w] = 1.0
    return images, masks


@torch.no_grad()
def first_bn_statistics64(conv, batches):
    """The batch-size-weighted mean over ``batches`` (NCHW) of the mean and biased
    variance of ``conv``'s output, computed in float64 from the fp32 weights."""
    import torch.nn.functional as F

    mean = var = 0.0
    n = 0
    for x in batches:
        y = F.conv2d(x.double(), conv.weight.double(), None if conv.bias is None else conv.bias.double(),
                     conv.stride, conv.padding, conv.dilation, conv.groups)
        mean = mean + x.shape[0] * y.mean(dim=(0, 2, 3))
        var = var + x.shape[0] * y.var(dim=(0, 2, 3), unbiased=False)
        n += x.shape[0]
    return mean / n, var / n


def finetune_case(smi, what, make_ft, batches, first, device, limits, steps=FT_STEPS) -> dict:
    """One fine-tuner on the card: one step's loss and gradients against the port's
    CPU run of the same batch, ``steps`` timed steps over ``batches`` (ms a step,
    images/s, peak memory, the loss must fall), then ``fit_arrays`` and its first
    BatchNorm's statistics against ``first_bn_statistics64``."""
    import copy

    ft, arrays, fit_batch = make_ft(device)
    model = ft.net.model if hasattr(ft, "net") else ft.predictor.model
    cpu_ft, _, _ = make_ft("cpu", copy.deepcopy(model).cpu())
    cpu_model = cpu_ft.net.model if hasattr(cpu_ft, "net") else cpu_ft.predictor.model
    b0 = batches[0]
    l_gpu = ft.step(*(t.to(device) for t in b0))
    l_cpu = cpu_ft.step(*b0)
    l_gpu, l_cpu = float(l_gpu[0] if isinstance(l_gpu, tuple) else l_gpu), float(
        l_cpu[0] if isinstance(l_cpu, tuple) else l_cpu)
    loss_rel, grad_rel, grad_global = limits
    share = grads_match(list(model.named_parameters()), list(cpu_model.parameters()), grad_rel, grad_global, what)
    log(f"{what}: one step, batch {b0[0].shape[0]}, loss {l_gpu:.6f} on the card, {l_cpu:.6f} on the CPU (relative "
        f"{abs(l_gpu - l_cpu) / abs(l_cpu):.3g}, limit {loss_rel}); gradients at most {share:.3g} of their limit (rel "
        f"{grad_rel}, global {grad_global})")
    if not (np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= loss_rel * abs(l_cpu)):
        raise AssertionError(f"{what}: loss {l_gpu} on the card, {l_cpu} on the CPU")
    del cpu_ft, cpu_model
    dev_batches = [tuple(t.to(device) for t in b) for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t = time.perf_counter()
    for i in range(steps):
        out = ft.step(*dev_batches[i % len(dev_batches)])
        losses.append(out[0] if isinstance(out, tuple) else out)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    first_k = np.mean(losses[:len(dev_batches)])
    last_k = np.mean(losses[-len(dev_batches):])
    log(f"main path ({what}): {steps} steps {ms:.2f} ms a step, {b0[0].shape[0] * 1e3 / ms:.1f} images/s, peak "
        f"memory {peak:.2f} GiB; losses {[round(v, 4) for v in losses]} [{smi}]")
    if not (np.isfinite(losses).all() and last_k < first_k):
        raise AssertionError(f"{what}: the loss did not fall over {steps} steps ({first_k} → {last_k})")
    t = time.perf_counter()
    ft.fit_arrays(*arrays, epochs=1, batch_size=fit_batch, log_every=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    conv, bn, inputs = first(model, arrays, fit_batch, device)
    mean64, var64 = first_bn_statistics64(conv, inputs)
    err = max(float(((bn.running_mean.double() - mean64).abs() / var64.sqrt()).max()),
              float(((bn.running_var.double() - var64).abs() / var64).max()))
    log(f"{what}: fit_arrays over {len(arrays[0])} items {fit_s:.2f} s; its first BatchNorm's recalibrated "
        f"statistics within {err:.3g} of a float64 computation (relative to the batch's std and variance; "
        f"limit {FT_STATS_REL})")
    if not err <= FT_STATS_REL:
        raise AssertionError(f"{what}: recalibrated statistics {err} from the float64 computation")
    return {"ms_per_step": ms, "images_per_s": b0[0].shape[0] * 1e3 / ms, "peak_gib": peak}


def finetune_phase(smi, device=None, cls_size=380, cls_batch=16, unet_size=320, unet_batch=4,
                   steps=FT_STEPS) -> dict:
    """3t: ``ClassifierFinetuner`` on EfficientNet-B3 at ``cls_size``², batch
    ``cls_batch``, on seeded crops labelled by their brightness, and
    ``UNetFinetuner`` on U2NETP at ``unet_size``², batch ``unet_batch``, on seeded
    bars and their masks; the head's dropout set to 0 so that the card and the CPU
    take the same step (``finetune_case``)."""
    import types

    from yolo_puncture_tpu_torch.models.efficientnet import preprocess_classifier
    from yolo_puncture_tpu_torch.tasks import ClassifierNet, UNetPredictor
    from yolo_puncture_tpu_torch.train import ClassifierFinetuner, UNetFinetuner

    dev = torch.device(device or "cuda")
    crops, labels = brightness_crops(4 * cls_batch, cls_size, seed=30)

    def make_cls(device, model=None):
        if model is None:
            net = ClassifierNet("efficientnet_b3", input_size=cls_size, seed=0, device=device)
        else:
            net = types.SimpleNamespace(model=model, device=torch.device(device), input_size=cls_size)
        net.model.drop_rate = 0.0
        return ClassifierFinetuner(net, lr=5e-4, seed=0), (crops, labels), cls_batch

    def first_cls(model, arrays, bs, device):
        x = torch.from_numpy(arrays[0]).to(device)
        return model.conv_stem, model.bn1, [preprocess_classifier(x[i:i + bs], cls_size)
                                            for i in range(0, len(x) - bs + 1, bs)]

    cls_batches = [(torch.from_numpy(crops[i:i + cls_batch]), torch.from_numpy(labels[i:i + cls_batch]))
                   for i in range(0, len(crops), cls_batch)]
    out = {"classifier": finetune_case(smi, f"ClassifierFinetuner B3 {cls_size}^2", make_cls, cls_batches,
                                       first_cls, dev, FT_LIMITS["classifier"], steps)}
    images, masks = bar_masks(4 * unet_batch, unet_size, seed=31)

    def make_unet(device, model=None):
        pred = UNetPredictor("u2netp", seed=0, device=device) if model is None else types.SimpleNamespace(
            model=model, device=torch.device(device))
        return UNetFinetuner(pred, lr=3e-4, seed=0), (images, masks), unet_batch

    def first_unet(model, arrays, bs, device):
        x = torch.from_numpy(arrays[0]).to(device).permute(0, 3, 1, 2)
        return (model.stage1.rebnconvin.conv_s1, model.stage1.rebnconvin.bn_s1,
                [x[i:i + bs] for i in range(0, len(x) - bs + 1, bs)])

    unet_batches = [(torch.from_numpy(images[i:i + unet_batch]), torch.from_numpy(masks[i:i + unet_batch]))
                    for i in range(0, len(images), unet_batch)]
    out["unet"] = finetune_case(smi, f"UNetFinetuner U2NETP {unet_size}^2", make_unet, unet_batches, first_unet,
                                dev, FT_LIMITS["unet"], steps)
    return out


# calibrate on the card against its CPU run: the counts and the duplicate rates equal; a and b are
# Newton's fit to the logits of a few hundred scores, which the card gives within a few 1e-6 of the CPU
CAL_FIT_REL = 1e-3


def calibrate_phase(tmp: str, smi: str, imgsz: int = 640, model: str = "yolo10s-seg", device=None) -> int:
    """3u: ``yolo_cli calibrate`` on the checkpoints that 3s's ``yolo_cli train``
    wrote into ``tmp/run``, over its PNG dataset's val split, on the CPU and then on
    the card (``proto_decode`` launched): the JSON fields against the CPU's, then
    ``YOLO.load_calibration`` of the directory reads the sidecar.  Returns the
    kernel's launches."""
    import contextlib
    import io

    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.apps import yolo_cli
    from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode

    argv = ["calibrate", f"data={os.path.join(tmp, 'data')}", f"model={os.path.join(tmp, 'run')}", f"arch={model}",
            f"imgsz={imgsz}"]
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ref = yolo_cli.main(argv, device="cpu")
    cpu_s = time.perf_counter() - t
    proto_decode.launches = 0
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        got = yolo_cli.main(argv, device=device)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    n = proto_decode.launches
    lines = buf.getvalue().splitlines()
    log(f"main path (yolo_cli calibrate, {model} {imgsz}^2, {got['n_images']} val images): proto_decode launched "
        f"{n} times; {card_s:.2f} s on the card with the model's build, {cpu_s:.2f} s on the CPU; lines {lines}; "
        f"card {json.dumps(got)}; CPU {json.dumps(ref)} [{smi}]")
    if n <= 0:
        raise AssertionError("calibrate did not launch proto_decode")
    for k in ("n_images", "n_det", "n_tp", "duplicate_rate"):
        if got[k] != ref[k]:
            raise AssertionError(f"calibrate's {k}: {got[k]} on the card, {ref[k]} on the CPU")
    for k in ("a", "b"):
        if not abs(got[k] - ref[k]) <= CAL_FIT_REL * abs(ref[k]) + 1e-9:
            raise AssertionError(f"calibrate's {k}: {got[k]} on the card, {ref[k]} on the CPU")
    sidecar = os.path.join(tmp, "run", "calibration.json")
    if not lines[0].endswith(f"→ {sidecar}") or YOLO(model, nc=1, device=device).load_calibration(
            os.path.join(tmp, "run")) != (got["a"], got["b"]):
        raise AssertionError("calibrate's sidecar is not where YOLO.load_calibration reads it")
    return n


# the exported serving graph against the eager module on the card
EXPORT_BOX_TOL, EXPORT_SCORE_TOL = 1e-3, 1e-5


def export_phase(tmp: str, smi: str, imgsz: int = 640, batch: int = 2, device=None) -> dict:
    """3v: ``yolo_cli export`` of the seeded YOLOv10-S seg: ``msgpack`` and
    ``torch`` files equal to the CPU's export; ``torch_export`` of the same
    weights with the class biases raised by 7 (so that the seeded head scores
    above the serving threshold 0.25), saved, reloaded by ``torch.export.load``
    in a process where the port cannot be imported and run there on the card,
    its outputs against the eager serving module's.  Returns the wall times."""
    import contextlib
    import io
    import pickle
    import re
    import subprocess as sp

    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.apps import yolo_cli

    times = {}
    for fmt in ("msgpack", "torch"):
        files = {}
        for where in ("cpu", device):
            files[where] = os.path.join(tmp, f"export_{where or 'card'}_yolo10s-seg.{fmt}")
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                yolo_cli.main(["export", "model=yolo10s-seg", f"format={fmt}", f"output={files[where]}"],
                              device=where)
            times[fmt if where != "cpu" else f"{fmt}_cpu"] = time.perf_counter() - t
        with open(files["cpu"], "rb") as a, open(files[device], "rb") as b:
            if fmt == "msgpack":
                same = a.read() == b.read()
            else:                         # pickles of numpy arrays: the same keys, types and values
                ref, got = pickle.load(a), pickle.load(b)
                same = sorted(ref) == sorted(got) and all(
                    got[k].dtype == v.dtype and np.array_equal(got[k], v) for k, v in ref.items())
        if not same:
            raise AssertionError(f"export format={fmt} on the card differs from the CPU's")
    weights = os.path.join(tmp, "raised_yolo10s-seg.pt")
    det = YOLO("yolo10s-seg", nc=1, seed=0, device=device)
    with torch.no_grad():
        for name, p in det.model.named_parameters():
            if re.fullmatch(r"model\.\d+\.one2one_cv3\.\d+\.2\.bias", name):
                p += 7.0
    torch.save({k: v.cpu() for k, v in det.model.state_dict().items()}, weights)
    graph = os.path.join(tmp, "serve.pt2")
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        yolo_cli.main(["export", f"model={weights}", "format=torch_export", f"imgsz={imgsz}", f"batch={batch}",
                       f"output={graph}"], device=device)
    times["torch_export"] = time.perf_counter() - t
    frames = np.random.default_rng(40).integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    np.save(os.path.join(tmp, "frames.npy"), frames)
    code = ("import sys\n"
            "sys.modules['yolo_puncture_tpu_torch'] = None\n"
            "import numpy as np, torch\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            f"ep = torch.export.load({graph!r})\n"
            f"x = torch.from_numpy(np.load({os.path.join(tmp, 'frames.npy')!r})).to({str(det.device)!r})\n"
            "with torch.no_grad():\n"
            "    out = ep.module()(x)\n"
            f"np.savez({os.path.join(tmp, 'served.npz')!r}, *[t.cpu().numpy() for t in out])\n")
    t = time.perf_counter()
    run = sp.run([sys.executable, "-c", code], cwd=tmp, capture_output=True, text=True, timeout=600,
                 env={**os.environ, "PYTHONPATH": ""})
    times["reload_and_run"] = time.perf_counter() - t
    if run.returncode != 0:
        raise AssertionError(f"the exported graph did not reload and run without the port: {run.stderr[-2000:]}")
    served = np.load(os.path.join(tmp, "served.npz"))
    det = YOLO(weights, nc=1, device=device)
    with torch.no_grad():
        boxes, scores, classes = (v.cpu().numpy() for v in
                                  yolo_cli.serving_module(det, imgsz)(torch.from_numpy(frames).to(det.device)))
    err = {"boxes": float(np.abs(served["arr_0"] - boxes).max()),
           "scores": float(np.abs(served["arr_1"] - scores).max()),
           "classes_equal": bool(np.array_equal(served["arr_2"], classes))}
    log(f"main path (yolo_cli export, YOLOv10-S seg): msgpack and torch equal to the CPU's export; torch_export at "
        f"({batch}, {imgsz}, {imgsz}, 3) uint8 ({os.path.getsize(graph)} bytes) reloaded and run on the card "
        f"without the port: {int((scores > 0).sum())} detections, against the eager module {json.dumps(err)} "
        f"(limits: boxes {EXPORT_BOX_TOL}, scores {EXPORT_SCORE_TOL}, classes equal); wall s "
        f"{json.dumps({k: round(v, 3) for k, v in times.items()})} [{smi}]")
    if not (err["boxes"] <= EXPORT_BOX_TOL and err["scores"] <= EXPORT_SCORE_TOL and err["classes_equal"]):
        raise AssertionError("the reloaded serving graph disagrees with the eager module")
    if not (scores > 0).any():
        raise AssertionError("the raised head gave no detection above 0.25: the comparison would be of zeros")
    return times


E2E_BATCH, E2E_ITERS, E2E_DEVICE_ITERS = 32, 8, 10


def bench_modes_phase(smi: str, imgsz: int = 640, batch: int = BENCH_BATCH, iters: int = BENCH_ITERS,
                      e2e_batch: int = E2E_BATCH, e2e_iters: int = E2E_ITERS,
                      e2e_device_iters: int = E2E_DEVICE_ITERS, device=None) -> dict:
    """3w: the bench's ``--mode e2e`` (its pipeline output against
    ``process_frames`` of the same frames outside the clock), ``--mode
    e2e_device``, ``--unfused`` and ``--long-term``, each with its kernels'
    launches, each line printed.  Returns the launches by kernel."""
    from yolo_puncture_tpu_torch import bench as bm
    from yolo_puncture_tpu_torch.ops.kernels import decode_tail as dt
    from yolo_puncture_tpu_torch.ops.kernels import memory_readout as mr
    from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode

    def zero():
        mr.memory_readout.launches = dt.decode_tail.launches = 0
        proto_decode.launches = proto_decode.launches_bf16 = 0

    def counts():
        torch.cuda.synchronize()
        return {"proto_decode": proto_decode.launches, "proto_decode_bf16": proto_decode.launches_bf16,
                "memory_readout_bf16": mr.memory_readout.launches, "decode_tail_bf16": dt.decode_tail.launches}

    total = {"proto_decode_bf16": 0, "memory_readout_bf16": 0, "decode_tail_bf16": 0}
    lines = {}
    zero()
    res, details = bm.run_e2e(e2e_batch, e2e_iters, imgsz, device=device)
    got = counts()
    n_frames = e2e_batch * e2e_iters
    again = details["pipeline"].process_frames(list(bm.domain_frames(n_frames)), fps=30.0)
    out = details["output"]
    same = (np.array_equal(np.asarray(out.lens), np.asarray(again.lens))
            and (out.start_frame, out.end_frame, out.speed_mm_s) == (again.start_frame, again.end_frame,
                                                                     again.speed_mm_s))
    log(f"main path (bench --mode e2e, bf16 YOLOv10-S and B3, {n_frames} frames in batches of {e2e_batch}): "
        f"launches {json.dumps(got)}; {details['seconds']:.3f} s; key frames {out.start_frame}-{out.end_frame}, speed "
        f"{out.speed_mm_s}, {int(np.sum(out.detected))} frames detected; the same as process_frames outside the "
        f"bench: {same} [{smi}]")
    if got["proto_decode_bf16"] != e2e_iters + 1 or got["proto_decode"] or not same:
        raise AssertionError("bench --mode e2e: proto_decode_bf16 not once a batch, or its output differs from "
                             "process_frames'")
    lines["e2e"] = res
    total["proto_decode_bf16"] += got["proto_decode_bf16"]
    del details, again
    zero()
    res, details = bm.run_e2e_device(e2e_batch, e2e_device_iters, imgsz, device=device)
    got = counts()
    log(f"main path (bench --mode e2e_device, B {e2e_batch} staged once, {e2e_device_iters} chained iterations): "
        f"launches {json.dumps(got)}; checksum {details['chk']}, {details['seconds']:.3f} s [{smi}]")
    if got["proto_decode_bf16"] != e2e_device_iters + 1 or not np.isfinite(details["chk"]):
        raise AssertionError("bench --mode e2e_device: proto_decode_bf16 not once an iteration, or no checksum")
    lines["e2e_device"] = res
    total["proto_decode_bf16"] += got["proto_decode_bf16"]
    for name, kw in (("--unfused", {"fused": False}), ("--long-term", {"long_term": True})):
        zero()
        res, details = bm.run_bench(batch, iters, imgsz, track=True, device=device, **kw)
        got = counts()
        n_steps = iters + 1
        log(f"main path (bench {name}, B {batch}): {n_steps} steps launched {json.dumps(got)}; steps ms "
            f"{[round(v, 3) for v in details['steps_ms']]}, checksum {details['chk']} [{smi}]")
        if got["proto_decode_bf16"] != n_steps or got["decode_tail_bf16"] <= 0 or not np.isfinite(details["chk"]):
            raise AssertionError(f"bench {name}: launches {got}")
        if (got["memory_readout_bf16"] > 0) != (name == "--unfused"):
            raise AssertionError(f"bench {name}: memory_readout launched {got['memory_readout_bf16']} times (the "
                                 "long-term readout is the dense one; the unfused tracker's is the kernel)")
        lines[name] = res
        for k in total:
            total[k] += got[k]
    for name, res in lines.items():
        log(f"bench {name}:")
        print(smi, flush=True)
        print(json.dumps(res), flush=True)
    return total


# ---------------------------------------------------------------------------
# 3x. video files: the clips written as mp4 and read back by the entry points
# ---------------------------------------------------------------------------


def write_mp4(path: str, frames_bgr, fps: float = 30.0) -> list:
    """Write BGR frames as an mp4 (cv2's ``mp4v``) and read it back: returns the
    decoded BGR frames, as cv2 hands them to every reader of the file."""
    import cv2

    h, w = frames_bgr[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter.fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise AssertionError(f"cv2 cannot write {path}")
    for f in frames_bgr:
        writer.write(np.ascontiguousarray(f))
    writer.release()
    cap = cv2.VideoCapture(path)
    decoded = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        decoded.append(f)
    cap.release()
    if len(decoded) != len(frames_bgr) or decoded[0].shape != frames_bgr[0].shape:
        raise AssertionError(f"{path}: wrote {len(frames_bgr)} frames, read {len(decoded)}")
    return decoded


def video_phase(smi: str, pipe, pipe_conf: float, clip, tv_argv, tv_frames, app_conf: float, imgsz: int = 640,
                out_dir=None, device=None):
    """3x: the needle clip and the tracking app's bar clip written as mp4 files with
    cv2 and read by the entry points, each held to the run on the frames decoded
    from the same file: ``process_videos`` against ``process_frames`` (equal
    output), ``track_video``'s ``main`` on the mp4 against ``run_track_app`` on
    the ``VideoReader``'s frames (equal ``pred.json`` segments, id maps), and the
    app's video mode (``yolo_inference`` reads and writes mp4) against
    ``annotate_video`` on the decoded frames (equal info, every frame written).
    ``tv_argv``: the app's flags without ``--img_path`` and ``--output``.
    Returns (launches by kernel, the needle mp4's path, its decoded frames)."""
    from yolo_puncture_tpu_torch.apps import app as app_mod
    from yolo_puncture_tpu_torch.apps import track_video as tv
    from yolo_puncture_tpu_torch.ops.kernels import decode_tail as dt
    from yolo_puncture_tpu_torch.ops.kernels import memory_readout as mr
    from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode
    from yolo_puncture_tpu_torch.pipeline.video import VideoReader, sort_key
    from yolo_puncture_tpu_torch.utils.png import decode_png

    out_dir = out_dir or os.path.join(ROOT, "build", "video")
    os.makedirs(out_dir, exist_ok=True)
    launches = {"proto_decode": 0, "memory_readout": 0, "decode_tail": 0}
    t = time.perf_counter()
    needle_mp4 = os.path.join(out_dir, "needle.mp4")
    decoded = write_mp4(needle_mp4, list(clip))
    log(f"video files: {needle_mp4} ({len(decoded)} frames {decoded[0].shape[1]}x{decoded[0].shape[0]}, "
        f"{os.path.getsize(needle_mp4)} bytes) written and read back in {time.perf_counter() - t:.1f} s; mean abs "
        f"difference from the frames written {float(np.abs(np.stack(decoded).astype(np.int16) - clip).mean()):.3f}")

    # the speed pipeline on the file
    proto_decode.launches = 0
    outs = pipe.process_videos([needle_mp4], conf=pipe_conf)
    sync()
    launches["proto_decode"] += proto_decode.launches
    ref = pipe.process_frames(decoded, 30.0, conf=pipe_conf)
    same_pipeline_output(outs["needle"], ref)
    log(f"main path (process_videos on {needle_mp4}): proto_decode launched {proto_decode.launches} times; the same "
        f"as process_frames on its decoded frames: {json.dumps(check_pipeline_output(outs['needle'], len(decoded), *decoded[0].shape[:2]))}")
    if proto_decode.launches <= 0:
        raise AssertionError("process_videos did not launch proto_decode")

    # the tracking app on the file
    bar_mp4 = os.path.join(out_dir, "bar.mp4")
    write_mp4(bar_mp4, [f[..., ::-1] for f in tv_frames])
    runs = {}
    for what in ("file", "frames"):
        out = os.path.join(out_dir, f"track_{what}")
        mr.memory_readout.launches = dt.decode_tail.launches = proto_decode.launches = 0
        if what == "file":
            tv.main(list(tv_argv) + ["--img_path", bar_mp4, "--output", out], device=device)
            name = tv.make_config(tv.parse_args(list(tv_argv) + ["--img_path", bar_mp4, "--output", out]),
                                  len(tv_frames))["video_name"]
            with open(os.path.join(out, "pred.json")) as f:
                pred = json.load(f)
            ann = os.path.join(out, "Annotations", name)
            ids = [decode_png(open(os.path.join(ann, p), "rb").read())
                   for p in sorted(os.listdir(ann), key=sort_key)]                      # frame_2 before frame_10
        else:
            reader = VideoReader(bar_mp4)
            run = run_track_app(list(tv_argv) + ["--img_path", bar_mp4, "--output", out],
                                [reader[i][0] for i in range(len(reader))], device=device)
            pred = run["pred"]
            ann = os.path.join(out, "Annotations", run["cfg"]["video_name"])
            ids = [decode_png(open(os.path.join(ann, p), "rb").read()) for p in sorted(os.listdir(ann))]
        sync()
        runs[what] = (pred, ids, {"proto_decode": proto_decode.launches, "memory_readout": mr.memory_readout.launches,
                                  "decode_tail": dt.decode_tail.launches})
    (pf, idf, lf), (pr, idr, _) = runs["file"], runs["frames"]
    seg = [[s["id"] for s in a["segments_info"]] for a in pf["annotations"]]
    agree = float(np.mean([(a == b).mean() for a, b in zip(idf, idr)])) if len(idf) == len(idr) else 0.0
    log(f"main path (track_video main on {bar_mp4}, {len(tv_frames)} frames): launches {json.dumps(lf)}; segments "
        f"per frame {[len(s) for s in seg]}; annotation PNGs equal to the run on the VideoReader's frames on "
        f"{agree:.6f} of the pixels")
    if [[s["id"] for s in a["segments_info"]] for a in pr["annotations"]] != seg or agree < TRACK_ID_AGREE:
        raise AssertionError("track_video on the mp4 differs from its run on the decoded frames")
    if min(lf.values()) <= 0:
        raise AssertionError(f"track_video on the mp4 did not launch every kernel: {lf}")
    for k, n in lf.items():
        launches[k] += n

    # the app's video mode: reads the mp4 and writes an annotated one
    proto_decode.launches = 0
    _, out_mp4, info = app_mod.yolo_inference(None, needle_mp4, yolo_conf_threshold=app_conf, imgsz=imgsz,
                                              return_info=True, device=device)
    sync()
    app_launches = proto_decode.launches
    vpipe, vunet = app_mod.build_video_models(app_mod.build_detector("seg/yolo11n-seg-finetune.pt", device),
                                              "u2netp_finetune_70.pth", "EfficientNet/efficientnet_b3.pth.tar", 8,
                                              imgsz, 380)
    _, ref_info = app_mod.annotate_video(decoded, 30.0, vpipe, vunet, app_conf, 20, 380)
    import cv2

    cap = cv2.VideoCapture(out_mp4)
    n_out = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    os.remove(out_mp4)
    log(f"main path (the app's video mode on {needle_mp4}): proto_decode launched {app_launches} times; "
        f"{json.dumps(info)}; {n_out} frames written; annotate_video on the decoded frames: {json.dumps(ref_info)}")
    if info != ref_info or n_out != len(decoded) or app_launches <= 0:
        raise AssertionError("the app's mp4 video mode differs from annotate_video on the decoded frames")
    launches["proto_decode"] += app_launches
    log(f"video files phase: {time.perf_counter() - t:.1f} s [{smi}]")
    return launches, needle_mp4, decoded


# ---------------------------------------------------------------------------
# 3y. int8: convolutions, predict, serve, the int8 ring, the bench's int8 modes
# ---------------------------------------------------------------------------

# (a) YOLOv10-S's model.1 at B 4 of 640²: 32 → 64 channels, 3×3, stride 2, on a 320² map
INT8_CONV_CASE = (4, 32, 320, 320, 64, 3, 2)
# one int8 convolution on the card against its CPU run: the same int8 operands, the int32
# sums exact (float64 holds them), the dequantised output within this of its largest value
INT8_OUT_REL = 1e-6
# every int8 convolution of a model on the card, fed the card's own input of that
# convolution in the int8 forward, is held to the CPU's int8 convolution of the same
# input within INT8_OUT_REL (check_int8_layers).  The whole model cannot be held so
# closely: fp32 activations that differ in the last bit (cuDNN's and the CPU's sums)
# put some int8 operands on the other side of a rounding tie, which later layers carry
# on, as between the port and the JAX package on the CPU (tests/test_torch_quant.py).
# So, as there, the card's int8 head is held to the CPU's int8 head within INT8_DIRECT
# times the CPU's int8-versus-fp gap (the CPU int8 head against the card's fp head: a
# gap the card's int8 result does not enter; mean abs over every anchor), and lies more
# than INT8_RAN times that gap from the card's fp head (the int8 path ran); predict's
# detections (counts, paired boxes, sorted scores) on the card within INT8_DIRECT times
# the CPU int8 run's distance from the card's fp run, or than compare_to_cpu's fp
# tolerances (INT8_PREDICT_FLOOR) where that distance is smaller: on a small input
# the selected boxes are mostly clipped to the frame, and either distance comes from a
# few of them.  Calibrated scales (the fp
# forward's percentiles) within INT8_SCALE_REL of the CPU's: fp32 sums in another
# order; in bf16 each layer rounds its output to 8 significant bits on both sides from
# other fp32 sums, so a scale moves by a few bf16 ulps, as the bf16 layers do
# (tests/test_torch_bf16.py LAYER_TOL)
INT8_DIRECT = 2.0
INT8_RAN = 0.5
INT8_PREDICT_FLOOR = {"count": 0, "boxes": 0.05, "scores": 1e-4}
INT8_SCALE_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -4}


def _paired_mean_err(a, b) -> float:
    """Mean abs difference of two (N, 4) box sets paired by least total L1 distance."""
    from scipy.optimize import linear_sum_assignment

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if len(a) == 0 or len(b) == 0:
        return 0.0
    r, c = linear_sum_assignment(np.abs(a[:, None] - b[None]).sum(-1))
    return float(np.abs(a[r] - b[c]).mean())


def int8_distance(got, ref) -> dict:
    """Two lists of ``Results`` of the same frames, the worst frame's: difference in
    detection counts; mean abs difference of the boxes paired by least L1
    distance and of the scores sorted (the best min(n, m) of each); share of equal
    pixels of the union of the masks."""
    out = {"count": 0, "boxes": 0.0, "scores": 0.0, "masks": 1.0}
    for g, r in zip(got, ref):
        n = min(len(g.boxes), len(r.boxes))
        out["count"] = max(out["count"], abs(len(g.boxes) - len(r.boxes)))
        out["boxes"] = max(out["boxes"], _paired_mean_err(g.boxes.xyxy, r.boxes.xyxy))
        if n:
            d = np.abs(np.sort(g.boxes.conf)[::-1][:n] - np.sort(r.boxes.conf)[::-1][:n])
            out["scores"] = max(out["scores"], float(d.mean()))
        if g.masks is not None and r.masks is not None and n:
            out["masks"] = min(out["masks"], float((g.masks.data.any(0) == r.masks.data.any(0)).mean()))
    return out


def int8_heads(det, frames, imgsz) -> dict:
    """The head's boxes and class scores over every anchor (numpy fp32) for
    ``frames`` letterboxed as ``predict`` does, under the predictor's int8 switch."""
    from yolo_puncture_tpu_torch.nn.quant import int8_convs
    from yolo_puncture_tpu_torch.ops.letterbox import letterbox

    imgs, _, _ = letterbox(torch.from_numpy(frames).to(det.device), imgsz, bgr_to_rgb=True, dtype=det.model.dtype)
    with torch.no_grad(), int8_convs(det.int8_serving, act_scales=det._act_scales if det.int8_serving else None):
        out = det.model(imgs)
    return {k: out[k].float().cpu().numpy() for k in ("boxes", "probs")}


def check_int8_heads(what: str, got: dict, ref: dict, base: dict) -> dict:
    """``got`` (an int8 head on the card) against ``ref`` (its CPU run) within
    INT8_DIRECT times the gap of ``ref`` from ``base`` (the fp head on the card),
    and ``got`` more than INT8_RAN times that gap from ``base``; mean abs over
    every anchor, as ``tests/test_torch_quant.py`` holds the port's whole model
    to the JAX package's.  Returns {output: (distance, gap, from fp)}."""
    out = {}
    for k in ("boxes", "probs"):
        g = got[k].astype(np.float64)
        d, gap, ran = (float(np.abs(a - b).mean()) for a, b in ((g, ref[k]), (ref[k], base[k]), (g, base[k])))
        out[k] = (d, gap, ran)
        if not (gap > 0 and d <= INT8_DIRECT * gap and ran > INT8_RAN * gap):
            raise AssertionError(f"{what}: {k} {d:.4g} from the CPU run and {ran:.4g} from fp, against the CPU's "
                                 f"int8-vs-fp gap {gap:.4g} (limits {INT8_DIRECT} x and more than {INT8_RAN} x)")
    return out


def check_int8_distance(what: str, got: dict, ref: dict) -> None:
    """``int8_distance`` of predict's int8 results on the card from its CPU run
    (``got``) within INT8_DIRECT times that of the CPU run from the card's fp run
    (``ref``) or INT8_PREDICT_FLOOR, whichever is larger, in detection counts,
    paired boxes and sorted scores."""
    for k, floor in INT8_PREDICT_FLOOR.items():
        if not got[k] <= INT8_DIRECT * max(ref[k], floor):
            raise AssertionError(f"{what}: {k} {got[k]:.4g} from the CPU run, not within {INT8_DIRECT} x the CPU "
                                 f"run's {ref[k]:.4g} from fp (or {floor})")


def check_int8_layers(det, cpu, frames, imgsz) -> dict:
    """Every int8 convolution of ``det`` (on the card) fed its input in the card's
    int8 forward of ``frames``, against the same convolution of ``cpu`` (the same
    model on the CPU) on the same input, with the predictor's scales: within
    INT8_OUT_REL of its largest value (YOLOv10's eval forward runs 72 of its 84:
    not the one-to-many head).  Returns the count and the worst."""
    from yolo_puncture_tpu_torch.nn import quant
    from yolo_puncture_tpu_torch.nn.common import ConvBN

    cpu_convs = dict(cpu.model.named_modules())
    inputs, hooks = {}, []
    for name, m in det.model.named_modules():
        if isinstance(m, ConvBN) and quant._eligible(m.conv):
            hooks.append(m.register_forward_pre_hook(lambda mod, args, name=name: inputs.__setitem__(name, args[0])))
    try:
        int8_heads(det, frames, imgsz)
    finally:
        for h in hooks:
            h.remove()
    worst = 0.0
    with torch.no_grad():
        for name, x in inputs.items():
            conv = det.model.get_submodule(name).conv
            scale = det._act_scales.get(conv.flax_path) if det._act_scales else None
            got = quant._int8_conv(conv, x, scale).float().cpu()
            ref = quant._int8_conv(cpu_convs[name].conv, x.cpu(), scale).float()
            worst = max(worst, float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)))
    if not inputs or not worst <= INT8_OUT_REL:
        raise AssertionError(f"{len(inputs)} int8 convolutions on the card: {worst:.3g} from the CPU's")
    return {"convolutions": len(inputs), "worst_rel": worst}


def check_int8_conv(device, case=INT8_CONV_CASE, seed=700) -> dict:
    """(a): ``nn/quant.py _int8_conv`` on the card against its CPU run on seeded
    fp32 inputs: the int8 operands equal, the int32 product equal to a float64
    convolution of the same int8 values, the output within INT8_OUT_REL; then
    the times of the int8 convolution (and of its ``int_mm`` alone) beside cuDNN's
    fp32 (TF32 off) and bf16 convolutions of the same shapes."""
    import copy

    import torch.nn.functional as F

    from yolo_puncture_tpu_torch.nn import quant

    B, C, H, W, O, k, s = case
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, C, H, W), generator=g)
    conv = torch.nn.Conv2d(C, O, k, s, k // 2, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * (C * k * k) ** -0.5)
    conv_d, xd = copy.deepcopy(conv).to(device), x.to(device)
    quant.freeze_int8_weights(conv)                      # as the predictor's model holds them
    quant.freeze_int8_weights(conv_d)
    xi, sx = quant.quantize_activation(x)
    ki, sk = quant.quantize_weight(conv.weight)
    xi_d, sx_d = quant.quantize_activation(xd)
    ki_d, sk_d = quant.quantize_weight(conv_d.weight)
    if not (torch.equal(xi_d.cpu(), xi) and torch.equal(ki_d.cpu(), ki) and torch.equal(sx_d.cpu(), sx)
            and torch.equal(sk_d.cpu(), sk)):
        raise AssertionError("int8 operands on the card differ from the CPU's")
    y = quant.conv2d_int8(xi_d, ki_d, conv.stride, conv.padding, conv.dilation)
    ref64 = F.conv2d(xi_d.double(), ki_d.double(), stride=conv.stride, padding=conv.padding)
    if y.dtype != torch.int32 or not torch.equal(y.double(), ref64):
        raise AssertionError("the int32 product on the card differs from a float64 convolution of its operands")
    with torch.no_grad():
        out_d = quant._int8_conv(conv_d, xd)
        out_c = quant._int8_conv(conv, x)
    rel = float((out_d.cpu() - out_c).abs().max() / out_c.abs().max())
    if not rel <= INT8_OUT_REL:
        raise AssertionError(f"the int8 convolution on the card is {rel:.3g} from the CPU's")
    cols, _ = quant._im2col(xi_d, k, k, conv.stride, conv.padding, conv.dilation)
    krows = quant._kernel_rows(ki_d)
    w16, x16 = conv_d.weight.to(torch.bfloat16), xd.to(torch.bfloat16)
    with torch.no_grad():
        ms = {"int8": cuda_time_ms(lambda: quant._int8_conv(conv_d, xd), iters=20, warmup=3),
              "int8 from a bf16 input": cuda_time_ms(lambda: quant._int8_conv(conv_d, x16), iters=20, warmup=3),
              "int_mm alone": cuda_time_ms(lambda: quant.int_mm(cols, krows), iters=20, warmup=3),
              "cudnn fp32": cuda_time_ms(lambda: conv_d(xd), iters=20, warmup=3),
              "cudnn bf16": cuda_time_ms(lambda: F.conv2d(x16, w16, stride=s, padding=k // 2), iters=20, warmup=3)}
    Ho, Wo = y.shape[2:]
    ops = 2 * B * Ho * Wo * O * C * k * k
    return {"max_rel_err": rel, "ms": ms, "int8_ops": ops, "im2col_bytes": cols.numel(),
            "int8_bound_ms": max(ops / INT8_OPS_PER_S, (x.numel() * 4 + out_c.numel() * 4) / HBM_BYTES_PER_S) * 1e3}


def int8_phase(smi: str, frames, calib_video: str, calib_frames, serve_frames, pngs, queries, probs32,
               track_frames, track_masks, conf: float = 0.018, imgsz: int = 640, bench_batch: int = BENCH_BATCH,
               bench_iters: int = BENCH_ITERS, device=None, tmp=None) -> dict:
    """3y: (a) one int8 convolution (``check_int8_conv``); (b) ``YOLO(int8_serving=True)
    .predict`` of ``frames``, fp32 and bf16, with dynamic scales and after
    ``calibrate_int8`` of ``calib_video`` (predict's video source; the same scales
    as from ``calib_frames``, its decoded frames), each held to the port's CPU run
    (INT8_DIRECT) and timed beside fp32 and bf16; (c) ``serve --int8 --calib_dir``
    over ``pngs`` from SERVE_CLIENTS clients, each response held to a direct int8
    predict; (d) the int8-ring tracker at 480×864 with the needle checkpoint over
    the bar clip against its CPU run, beside ``probs32`` (the fp32 tracker's);
    (e) the bench's ``--int8-det``, ``--int8-det --int8-static`` and ``--int8-mem``
    in turns with the default step.  Returns the launches by kernel."""
    import contextlib
    import io

    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch import bench as bm
    from yolo_puncture_tpu_torch.apps import serve
    from yolo_puncture_tpu_torch.ops.kernels import decode_tail as dt
    from yolo_puncture_tpu_torch.ops.kernels import memory_readout as mr
    from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode
    from yolo_puncture_tpu_torch.track import TrackerCore

    t_phase = time.perf_counter()
    dev = torch.device(device or "cuda")
    launches = {"proto_decode": 0, "proto_decode_bf16": 0, "decode_tail": 0, "memory_readout_bf16": 0,
                "decode_tail_bf16": 0}
    conv = check_int8_conv(dev)
    log(f"int8 convolution {INT8_CONV_CASE} (B, C, H, W, O, k, stride) on the card: operands equal to the CPU's, int32 "
        f"sums equal to float64, output {conv['max_rel_err']:.3g} from the CPU's; ms {json.dumps(conv['ms'])}; "
        f"{conv['int8_ops']} int8 operations (bound {conv['int8_bound_ms']:.4f} ms), an im2col of "
        f"{conv['im2col_bytes']} bytes [{smi}]")

    # (b) predict
    kw = dict(conf=conf, imgsz=imgsz)
    times = {}
    for dtype in (torch.float32, BF16):
        name = "bf16" if dtype == BF16 else "fp32"
        det_fp = YOLO("yolo10s-seg", nc=1, seed=0, dtype=dtype, device=device)
        det8 = YOLO("yolo10s-seg", nc=1, seed=0, dtype=dtype, int8_serving=True, device=device)
        cpu8 = YOLO("yolo10s-seg", nc=1, seed=0, dtype=dtype, int8_serving=True, device="cpu")
        ref_fp = det_fp.predict(list(frames), **kw)
        for mode in ("dynamic", "calibrated"):
            if mode == "calibrated":
                t = time.perf_counter()
                scales = dict(det8.calibrate_int8(calib_video, imgsz=imgsz))
                cal_s = time.perf_counter() - t
                same = det8.calibrate_int8(list(calib_frames), imgsz=imgsz) == scales
                few = det8.calibrate_int8(list(calib_frames[:2]), imgsz=imgsz)
                cpu_few = cpu8.calibrate_int8(list(calib_frames[:2]), imgsz=imgsz)
                worst = max(abs(few[k] - cpu_few[k]) / cpu_few[k] for k in cpu_few)
                log(f"calibrate_int8 ({name}) over {calib_video} ({len(calib_frames)} frames): {len(scales)} scales in "
                    f"{cal_s:.2f} s, equal to those of its decoded frames: {same}; on two frames the card's within "
                    f"{worst:.3g} of the CPU's")
                if not same or set(few) != set(cpu_few) or worst > INT8_SCALE_REL[dtype] or len(scales) != 84:
                    raise AssertionError("calibrate_int8 on the video, its frames or the CPU disagree")
                det8._act_scales = scales
                cpu8._act_scales = dict(scales)
            proto_decode.launches = proto_decode.launches_bf16 = 0
            got = det8.predict(list(frames), **kw)
            sync()
            n = proto_decode.launches_bf16 if dtype == BF16 else proto_decode.launches
            launches["proto_decode_bf16" if dtype == BF16 else "proto_decode"] += n
            check_results(got, len(frames), *frames[0].shape[:2])
            cpu_got = cpu8.predict(list(frames), **kw)
            gap, vs_cpu, cpu_gap = (int8_distance(a, b) for a, b in ((got, ref_fp), (got, cpu_got),
                                                                      (cpu_got, ref_fp)))
            what = f"int8 predict ({name}, {mode} scales) against its CPU run"
            layers = check_int8_layers(det8, cpu8, frames, imgsz)
            heads = check_int8_heads(what, int8_heads(det8, frames, imgsz), int8_heads(cpu8, frames, imgsz),
                                     int8_heads(det_fp, frames, imgsz))
            check_int8_distance(what, vs_cpu, cpu_gap)
            log(f"main path (predict, {name} int8, {mode} scales, B {len(frames)}): proto_decode"
                f"{'_bf16' if dtype == BF16 else ''} launched {n} times; detections {[len(r) for r in got]} ({name}: "
                f"{[len(r) for r in ref_fp]}); predict's int8 results against {name} on the card {json.dumps(gap)}, "
                f"against its CPU run {json.dumps(vs_cpu)}, the CPU run against {name} on the card "
                f"{json.dumps(cpu_gap)}; each int8 convolution on its card input against the CPU's "
                f"{json.dumps(layers)}; the head over every anchor (from the CPU run, the CPU run from {name} on "
                f"the card, the card's from {name}): {json.dumps(heads)} [{smi}]")
            if n <= 0 or (gap["count"] == 0 and gap["boxes"] == 0 and gap["scores"] == 0):
                raise AssertionError(f"int8 predict ({name}) did not launch proto_decode or ran no int8 product")
            times[f"{name} int8 {mode}"] = host_ms(lambda: det8.predict(list(frames), **kw))
        times[name] = host_ms(lambda: det_fp.predict(list(frames), **kw))
        del det_fp, det8, cpu8
    log(f"predict B {len(frames)} of {frames[0].shape[0]}x{frames[0].shape[1]} at {imgsz}, ms (3 calls each): " + "; ".join(
        f"{k} median {sorted(v)[1]:.1f} ({[round(x, 1) for x in v]})" for k, v in times.items()) + f" [{smi}]")

    # (c) serve --int8 --calib_dir
    tmp = tmp or os.path.join(ROOT, "build", "int8_calib")
    os.makedirs(tmp, exist_ok=True)
    for i, png in enumerate(pngs[:4]):
        with open(os.path.join(tmp, f"calib{i}.png"), "wb") as f:
            f.write(png)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        server, _ = serve.make_server(["--int8", "--calib_dir", tmp, "--host", "127.0.0.1", "--port", "0",
                                       "--imgsz", str(imgsz)], device=device)
    line = buf.getvalue().strip()
    model = server.batcher.model
    if line != f"int8 calibration: {len(model._act_scales)} conv scales frozen from {tmp}" or not model.int8_serving:
        raise AssertionError(f"serve --int8 --calib_dir printed {line!r}")
    server.start()
    try:
        drive_server(server, pngs[:SERVE_CLIENTS], queries[:SERVE_CLIENTS])          # warm-up
        stats0 = json.loads(http_get(f"http://127.0.0.1:{server.port}/stats")[1])
        proto_decode.launches = 0
        t = time.perf_counter()
        responses, latency = drive_server(server, pngs, queries)
        serve_s = time.perf_counter() - t
        sync()
        serve_launches = proto_decode.launches
        stats = json.loads(http_get(f"http://127.0.0.1:{server.port}/stats")[1])
    finally:
        server.stop()
    n_exact = n_boxes = 0
    for (code, got), frame, i in zip(responses, serve_frames, range(len(pngs))):
        if code != 200:
            raise AssertionError(f"int8 request {i} answered {code} {got}")
        ref = serve.result_json(model.predict([frame], conf=conf, retina_masks=i % 2 == 1, imgsz=imgsz)[0],
                                got["batch"], (-1, 0, 2)[i % 3])
        n_exact += same_serve_json(got, ref, frame.shape[:2])
        n_boxes += len(got["boxes"])
    batches = stats["batches"] - stats0["batches"]
    log(f"main path (serve --int8 --calib_dir, {len(pngs)} PNG uploads from {SERVE_CLIENTS} clients): proto_decode "
        f"launched {serve_launches} times over {batches} device batches, {n_boxes} boxes; {n_exact} of {len(pngs)} "
        f"responses equal to a direct int8 predict (static scales) to the last digit, the others within a rounding "
        f"step; request latency ms p50 "
        f"{np.percentile(latency, 50):.1f} p99 {np.percentile(latency, 99):.1f}, {len(pngs) / serve_s:.2f} requests/s "
        f"[{smi}]")
    if serve_launches <= 0 or n_boxes == 0:
        raise AssertionError("the int8 server did not launch proto_decode or found nothing")
    launches["proto_decode"] += serve_launches
    del server, model

    # (d) the int8 ring
    core8 = TrackerCore(enable_long_term=False, variables=NEEDLE, quantized_memory=True, device=device,
                        **TRACK_GEOMETRY)
    mr.memory_readout.launches = dt.decode_tail.launches = 0
    probs8 = drive_tracker(core8, track_frames, track_masks)
    sync()
    got = (mr.memory_readout.launches, dt.decode_tail.launches)
    check_tracker_probs(probs8, len(probs8), core8)
    cpu8 = TrackerCore(enable_long_term=False, variables=NEEDLE, quantized_memory=True, device="cpu",
                       **TRACK_GEOMETRY)
    probs_cpu = drive_tracker(cpu8, track_frames, track_masks, upto_first_window=True)
    err = float(np.abs(probs8[:len(probs_cpu)] - probs_cpu).max())
    agree = float((probs8[:len(probs_cpu)].argmax(1) == probs_cpu.argmax(1)).mean())
    vs32 = (float(np.abs(probs8 - probs32).max()), float((probs8.argmax(1) == probs32.argmax(1)).mean()))
    step_frames = [track_frames[6 + (i % 4)] for i in range(5)]
    step_ms = host_ms(lambda: [core8.step(f) for f in step_frames])
    window_ms = host_ms(lambda: core8.step_batch(step_frames))
    log(f"main path (tracker with the int8 ring, {len(probs8)} frames at 480x864, needle checkpoint): memory_readout "
        f"launched {got[0]} times, decode_tail {got[1]}; against its CPU run over {len(probs_cpu)} frames: max abs "
        f"prob diff {err:.3g} (tol {TRACK_PROB_TOL}), id maps equal {agree:.6f}; against the fp32 ring on the card: "
        f"{vs32[0]:.3g}, ids {vs32[1]:.6f}; 5 steps {sorted(step_ms)[1]:.1f} ms, a 5-frame window "
        f"{sorted(window_ms)[1]:.1f} ms (median of 3) [{smi}]")
    if got[0] != 0 or got[1] <= 0:
        raise AssertionError(f"the int8-ring tracker launched memory_readout {got[0]} times and decode_tail {got[1]}")
    if not (err <= TRACK_PROB_TOL and agree >= TRACK_ID_AGREE):
        raise AssertionError("the int8-ring tracker on the card disagrees with its CPU run")
    launches["decode_tail"] += got[1]
    del core8, cpu8

    # (e) the bench's int8 steps, in turns with the default step
    lines = {}
    for name, kw in (("default", {}), ("--int8-det", {"int8_det": True}),
                     ("--int8-det --int8-static", {"int8_det": True, "int8_static": True}),
                     ("--int8-mem", {"int8_mem": True}), ("default ", {})):
        mr.memory_readout.launches = dt.decode_tail.launches = 0
        proto_decode.launches = proto_decode.launches_bf16 = 0
        torch.cuda.reset_peak_memory_stats()
        res, details = bm.run_bench(bench_batch, bench_iters, imgsz, track=True, device=device, **kw)
        sync()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_steps = bench_iters + 1
        got = (proto_decode.launches_bf16, mr.memory_readout.launches, dt.decode_tail.launches)
        log(f"main path (bench {name.strip()}, B {bench_batch}): {n_steps} steps launched proto_decode_bf16 {got[0]}, "
            f"memory_readout {got[1]}, decode_tail {got[2]} times; steps ms "
            f"{[round(v, 3) for v in details['steps_ms']]}, median {res['median_step_ms']:.3f}, checksum "
            f"{details['chk']}, peak memory {peak:.2f} GiB"
            + (f", {details['static_scales']} static scales" if details["static_scales"] else "") + f" [{smi}]")
        want_readouts = 0 if kw.get("int8_mem") else n_steps * bench_batch // 4
        if got != (n_steps, want_readouts, n_steps) or not np.isfinite(details["chk"]):
            raise AssertionError(f"bench {name.strip()} launched {got}, not one decode, {want_readouts} readouts and "
                                 "one tail a step")
        if kw:
            launches["proto_decode_bf16"] += got[0]
            launches["memory_readout_bf16"] += got[1]
            launches["decode_tail_bf16"] += got[2]
        lines[name.strip() + (" (again)" if name.endswith(" ") else "")] = res
    for name, res in lines.items():
        log(f"bench {name}:")
        print(smi, flush=True)
        print(json.dumps(res), flush=True)
    log(f"int8 phase: {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return launches


# -- 3z: the rest of the model zoo, VAN and SAM ------------------------------------------------------------
# VAN-B0 on the card against the port's CPU run of the same crops (fp32, TF32 off on both): the logits differ by
# the order of cuDNN's and the CPU's sums through 13 blocks, a few 1e-6 of a probability; bf16 against fp32 on
# the card: a bf16 rounding of every activation, as 3f's B3 (CLS_BF16_PROB_MEAN 1e-2 mean) but held at the max;
# and it must be measurably bf16: its mean distance from fp32 at least VAN_BF16_AWAY times the fp32 distance between
# the card and the CPU (a bf16 model computing in fp32 would sit at the latter)
VAN_PROB_TOL = 1e-4
VAN_BF16_PROB_TOL = 1e-2
VAN_BF16_AWAY = 10.0
# every VAN variant's parameter count with a 2-class head: the JAX package's (``jax.eval_shape``;
# tests/test_torch_van.py holds this table to it)
VAN_PARAMS = {"van_b0": 3_849_314, "van_b1": 13_349_826, "van_b2": 26_066_498, "van_b3": 44_253_634,
              "van_b4": 59_771_202, "van_b5": 89_200_226, "van_b6": 199_061_954}
VAN_DEEP = ("van_b2", "van_b6")          # one forward each on the card: stage 3 of 12 and of 90 blocks
# SAM's encoder and one decoder batch on the card against the CPU: max abs difference over the largest value
SAM_REL_TOL = 1e-3
SAM_TYPES = ("vit_b", "vit_l", "vit_h")
# the seeded vit_b's decoder shaped so that the generator's default thresholds keep masks, as
# tests/test_torch_sam_amg.py shapes its weights: the hypernetworks' last layers scaled (mask logits of a few
# units, so that the stability filter passes) and the IoU head's bias shifted so that SAM_KEEP_SHARE of the
# frame's whole-crop points pass pred_iou_thresh (seeded IoU predictions sit near 0 and move with the geometry)
SAM_HYPER_GAIN = 20.0
SAM_KEEP_SHARE = 0.25


def van_variables(model) -> dict:
    """A port VAN's weights as the JAX package's variable tree (``params`` /
    ``batch_stats``, fp32 numpy): the inverse of ``export_classifier_state_dict``,
    which ``evaluate_speed --cls_init`` reads back from a msgpack file."""
    import re

    out = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        a = t.detach().float().cpu().numpy()
        mod, leaf = key.rsplit(".", 1)
        path = re.sub(r"^block(\d+)\.(\d+)", r"block\1_\2", mod).replace("dwconv.dwconv", "dwconv").split(".")
        if leaf == "weight" and a.ndim > 1:
            coll, name, a = "params", "kernel", a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        else:
            coll, name = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                          "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}.get(
                leaf, ("params", leaf))
        node = out[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return out


def sam_encoder_work(variant: str, img_size: int) -> tuple:
    """(operations, bytes) of one SAM encoder pass, reckoned from its shapes: the
    linear layers of every block (qkv, proj, MLP: 24·N·C² at N = grid² tokens),
    the global blocks' attention (q·kᵀ and the weighted sum, 4·N²·C, and the
    rel-pos bias, 4·N·grid·C), the windowed blocks' over 14² windows of the grid
    padded to a multiple of 14, the patch embedding and the neck; the bytes: the
    weights, the image and the embedding, once each."""
    from yolo_puncture_tpu_torch.models.sam import _VIT_CFG, PATCH, PROMPT_DIM, WINDOW

    dim, depth, _, global_idx = _VIT_CFG[variant]
    g = img_size // PATCH
    n, nw, t = g * g, (-(-g // WINDOW)) ** 2, WINDOW * WINDOW
    flops = (depth * 24 * n * dim * dim
             + len(global_idx) * (4 * n * n * dim + 4 * n * g * dim)
             + (depth - len(global_idx)) * nw * (4 * t * t * dim + 4 * t * WINDOW * dim)
             + 2 * n * dim * 3 * PATCH * PATCH + 2 * n * dim * PROMPT_DIM + 2 * n * PROMPT_DIM * PROMPT_DIM * 9)
    params = {"vit_b": 93_735_472, "vit_l": 312_342_832, "vit_h": 641_090_608}[variant]
    return flops, 4 * (params + 3 * img_size * img_size + PROMPT_DIM * n)


def shape_sam_for_masks(sam, frame: np.ndarray, **gen_kw) -> float:
    """Scale the seeded ``sam``'s hypernetworks by ``SAM_HYPER_GAIN`` and shift its
    IoU head so that ``SAM_KEEP_SHARE`` of the whole-frame crop's points pass the
    generator's default ``pred_iou_thresh``; returns the shift."""
    from yolo_puncture_tpu_torch.models.sam import SamAutomaticMaskGenerator

    dev = next(sam.parameters()).device
    with torch.no_grad():
        for mlp in sam.mask_decoder.output_hypernetworks_mlps:
            mlp.layers[2].weight *= SAM_HYPER_GAIN
        thresh = SamAutomaticMaskGenerator(sam, **gen_kw).pred_iou_thresh
        loose = SamAutomaticMaskGenerator(sam, **gen_kw, pred_iou_thresh=-1e9, stability_score_thresh=0.0)
        _, scores, _ = loose._candidates(torch.from_numpy(np.ascontiguousarray(frame)).to(dev), loose.points_per_side)
        shift = float(thresh - np.quantile(scores, 1.0 - SAM_KEEP_SHARE))
        sam.mask_decoder.iou_prediction_head.layers[2].bias += shift
    return shift


def same_sam_masks(got, ref) -> bool:
    return len(got) == len(ref) and all(
        g["bbox"] == r["bbox"] and g["area"] == r["area"] and g["crop_box"] == r["crop_box"]
        and g["predicted_iou"] == r["predicted_iou"] and np.array_equal(g["segmentation"], r["segmentation"])
        for g, r in zip(got, ref))


def zoo_phase(smi: str, clip, decoded=None, needle_mp4=None, imgsz: int = 640, device=None, van_size: int = 380,
              van_batch: int = 16, ft_steps: int = FT_STEPS, deep=VAN_DEEP, sam_size: int = 1024,
              sam_frame_hw=(720, 1280), sam_types=SAM_TYPES, points_per_side: int = 32, sam_batch: int = 64) -> dict:
    """3z: VAN and SAM.  ``ClassifierNet("van_b0")`` fp32 and bf16 on ``van_batch``
    seeded crops of ``van_size``² against the port's CPU run; its forward timed
    beside EfficientNet-B3's at B 1 and B ``van_batch``; every VAN variant built
    with the JAX package's parameter count and ``deep``'s forwards; the speed
    pipeline with YOLOv10-S seg and VAN-B0 (fp32, then bf16) over ``clip``
    (``proto_decode`` once a batch), one batch's classifier held to the CPU on the
    same crops, frames/s beside B3's in turns; ``evaluate_speed --cls_model van_b0
    --cls_init`` (a msgpack of the same weights) over ``needle_mp4`` against the
    pipeline on the ``decoded`` frames; ``ClassifierFinetuner`` on VAN-B0
    (``finetune_case``).  SAM ``vit_b`` at ``sam_size``²: the encoder and one
    ``sam_batch``-point decoder batch against the CPU, the generator
    (``crop_n_layers=1``, downscale 2; the decoder shaped by
    ``shape_sam_for_masks``) on a seeded frame of ``sam_frame_hw``, the masks it
    keeps at the default thresholds equal over two runs, seconds a frame with its
    stages, host share and peak memory; ``segment_anything(frame, "vit_l")`` (the missing-checkpoint warning);
    one ``vit_h`` encoder pass; each encoder timed against its FLOP bound.
    Returns the kernels' launches on these paths."""
    import contextlib
    import copy
    import io
    import shutil
    import tempfile
    import types

    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.models.efficientnet import preprocess_classifier
    from yolo_puncture_tpu_torch.models.sam import SamAutomaticMaskGenerator, build_sam
    from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode
    from yolo_puncture_tpu_torch.pipeline import VideoSpeedPipeline
    from yolo_puncture_tpu_torch.registry import create_model
    from yolo_puncture_tpu_torch.tasks import ClassifierNet
    from yolo_puncture_tpu_torch.train import ClassifierFinetuner
    from yolo_puncture_tpu_torch.utils import segment_anything
    from yolo_puncture_tpu_torch.utils.convert import write_msgpack

    dev = torch.device(device or "cuda")
    t_phase = time.perf_counter()
    launches = {"proto_decode": 0, "proto_decode_bf16": 0}
    h0, w0 = clip.shape[1:3]

    # -- (a) ClassifierNet("van_b0") on the card against the CPU; bf16 against fp32 --------------------------------
    crops, _ = brightness_crops(van_batch, van_size, seed=40)
    x = torch.from_numpy(crops)
    van = ClassifierNet("van_b0", input_size=van_size, seed=0, device=dev)
    van16 = ClassifierNet("van_b0", input_size=van_size, seed=0, dtype=BF16, device=dev)
    van_cpu = ClassifierNet("van_b0", input_size=van_size, seed=0, device="cpu")
    p32, p16, pcpu = (net._forward(x.to(net.device))[2].float().cpu().numpy() for net in (van, van16, van_cpu))
    err, err16 = float(np.abs(p32 - pcpu).max()), float(np.abs(p16 - p32).max())
    away16 = float(np.abs(p16 - p32).mean())
    clear = np.abs(pcpu.max(1) - 0.5) > VAN_PROB_TOL                 # no class tie within the tolerance
    same_class = bool((p32.argmax(1) == pcpu.argmax(1))[clear].all())
    log(f"VAN-B0 {van_size}^2 B {van_batch} on the card vs the CPU: probabilities max abs {err:.3g} (tol "
        f"{VAN_PROB_TOL}), classes equal {same_class} ({int(clear.sum())} clear of a tie); bf16 vs fp32 max "
        f"{err16:.3g} "
        f"(tol {VAN_BF16_PROB_TOL}), mean {away16:.3g} ({away16 / max(err, 1e-30):.3g} times the fp32 card-CPU "
        f"distance, at least {VAN_BF16_AWAY}); probability of class 1 from {pcpu[:, 1].min():.4f} to "
        f"{pcpu[:, 1].max():.4f}")
    if not (err <= VAN_PROB_TOL and same_class and err16 <= VAN_BF16_PROB_TOL and away16 > 0
            and away16 >= VAN_BF16_AWAY * err):
        raise AssertionError("VAN-B0 on the card disagrees with its CPU run, or bf16 with fp32, or bf16 is not bf16")
    b3 = ClassifierNet("efficientnet_b3", input_size=van_size, seed=0, device=dev)
    b3_16 = ClassifierNet("efficientnet_b3", input_size=van_size, seed=0, dtype=BF16, device=dev)
    forward_ms = {}
    with torch.no_grad():
        for B in (1, van_batch):
            for what, nets in (("fp32", (van, b3)), ("bf16", (van16, b3_16))):
                xs = {n: preprocess_classifier(x[:B].to(dev), van_size, n.model.dtype) for n in nets}
                t = interleaved_times_ms({n: functools.partial(n.model, xs[n]) for n in nets}, launches=10, repeats=3)
                for n, name in zip(nets, ("van_b0", "efficientnet_b3")):
                    forward_ms[f"{name} {what} B{B}"] = t[n][1]
    log(f"classifier forward at {van_size}^2, ms (CUDA events, median of 3 repeats of 10, VAN and B3 in turns): "
        f"{json.dumps({k: round(v, 4) for k, v in forward_ms.items()})} [{smi}]")
    del van16, b3_16

    # -- (b) every variant on the card with the JAX package's parameter count; the deep ones forward ----------------
    counts = {}
    for name, want in VAN_PARAMS.items():
        m = create_model(name).to(dev)
        counts[name] = sum(p.numel() for p in m.parameters())
        if counts[name] != want:
            raise AssertionError(f"{name}: {counts[name]} parameters on the card, the JAX package has {want}")
        if name in deep:
            m.reset_parameters(torch.Generator().manual_seed(0))
            xb = preprocess_classifier(x[:1].to(dev), van_size)
            with torch.no_grad():
                logits = m(xb)
                ms = cuda_time_ms(lambda: m(xb), iters=5, warmup=2)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{name}: non-finite logits on the card")
            log(f"{name} ({len(m.block3)} blocks in stage 3) one {van_size}^2 forward {ms:.3f} ms, logits "
                f"{logits.float().cpu().numpy().round(4).tolist()} [{smi}]")
        del m
    log(f"VAN b0-b6 built on the card with the JAX package's parameter counts: {json.dumps(counts)}")

    # -- (c) the speed pipeline with VAN-B0, fp32 then bf16; frames/s beside B3's -------------------------------------
    det = YOLO("yolo10s-seg", nc=1, seed=0, device=dev)
    pipe = VideoSpeedPipeline(det, van, device_batch=8, imgsz=imgsz, crop_size=van_size)
    conf, gap = pipeline_conf(pipe, clip)
    n_batches = -(-len(clip) // pipe.device_batch)
    proto_decode.launches = proto_decode.launches_bf16 = 0
    out = pipe.process_frames(list(clip), fps=30.0, conf=conf)
    sync()
    got = (proto_decode.launches, proto_decode.launches_bf16)
    summary = check_pipeline_output(out, len(clip), h0, w0)
    log(f"main path (speed pipeline, YOLOv10-S seg and VAN-B0 at {van_size}^2, {len(clip)} frames, conf {conf:.6f} in a "
        f"gap of {gap:.3g}): proto_decode launched {got[0]} times for {n_batches} batches; {json.dumps(summary)}")
    if got != (n_batches, 0):
        raise AssertionError(f"the VAN pipeline launched proto_decode {got}, not once a batch")
    launches["proto_decode"] += got[0]
    step = pipeline_step_numpy(pipe, clip[:8], 0.0)
    cpu_crops = pipe._crops(torch.from_numpy(clip[:8]), torch.from_numpy(step["box"]))
    p_step = van_cpu._forward(cpu_crops)[1].numpy()
    step_err = float(np.abs(step["cls_prob"] - p_step).max())
    log(f"VAN pipeline step (frames 0-7 at conf 0): the card's classifier vs the CPU's on the same crops, max abs "
        f"{step_err:.3g} (tol {VAN_PROB_TOL})")
    if not step_err <= VAN_PROB_TOL:
        raise AssertionError("the VAN pipeline's classifier on the card disagrees with the CPU on the same crops")
    pipe16 = VideoSpeedPipeline(YOLO("yolo10s-seg", nc=1, seed=0, dtype=BF16, device=dev),
                                ClassifierNet("van_b0", input_size=van_size, seed=0, dtype=BF16, device=dev),
                                device_batch=8, imgsz=imgsz, crop_size=van_size)
    conf16, _ = pipeline_conf(pipe16, clip)
    proto_decode.launches = proto_decode.launches_bf16 = 0
    out16 = pipe16.process_frames(list(clip), fps=30.0, conf=conf16)
    sync()
    got16 = (proto_decode.launches, proto_decode.launches_bf16)
    summary16 = check_pipeline_output(out16, len(clip), h0, w0)
    s16 = pipeline_step_numpy(pipe16, clip[:8], 0.0)
    crops16 = pipe16._crops(torch.from_numpy(clip[:8]).to(dev), torch.from_numpy(s16["box"]).to(dev))
    step16_err = float(np.abs(s16["cls_prob"] - van._forward(crops16)[1].cpu().numpy()).max())
    log(f"main path (speed pipeline, bf16 YOLOv10-S and bf16 VAN-B0, conf {conf16:.6f}): proto_decode_bf16 launched "
        f"{got16[1]} times for {n_batches} batches; {json.dumps(summary16)}; its classifier vs the fp32 VAN on the "
        f"same crops, max abs {step16_err:.3g} (tol {VAN_BF16_PROB_TOL})")
    if got16 != (0, n_batches) or not step16_err <= VAN_BF16_PROB_TOL:
        raise AssertionError("the bf16 VAN pipeline must launch proto_decode_bf16 once a batch and agree with fp32")
    launches["proto_decode_bf16"] += got16[1]
    pipe_b3 = VideoSpeedPipeline(det, b3, device_batch=8, imgsz=imgsz, crop_size=van_size)
    runs = {}
    for name, p in (("van_b0", pipe), ("efficientnet_b3", pipe_b3), ("efficientnet_b3 ", pipe_b3), ("van_b0 ", pipe)):
        p.process_frames(list(clip), fps=30.0, conf=conf)                        # warm-up
        runs.setdefault(name.strip(), []).extend(host_ms(lambda: p.process_frames(list(clip), fps=30.0, conf=conf)))
    log(f"pipeline {len(clip)} frames {h0}x{w0}@{imgsz}, fp32, classifier in turns VAN-B0, B3, B3, VAN-B0 (3 calls "
        f"each turn), frames/s: " + "; ".join(f"{n} median {len(clip) / np.median(v) * 1e3:.1f} "
                                              f"({[round(t, 1) for t in v]} ms)" for n, v in runs.items()) + f" [{smi}]")
    del pipe16, pipe_b3, b3

    # -- (d) evaluate_speed --cls_model van_b0 --cls_init over the needle mp4 ----------------------------------------
    if needle_mp4 is not None:
        from yolo_puncture_tpu_torch.analytics.stats import compute_metrics
        from yolo_puncture_tpu_torch.apps import evaluate_speed as es
        from yolo_puncture_tpu_torch.utils.convert import export_classifier_state_dict

        tree = van_variables(van.model)
        sd = export_classifier_state_dict(tree)
        if any(not np.array_equal(sd[k], v.float().cpu().numpy()) for k, v in van.model.state_dict().items()
               if not k.endswith("num_batches_tracked")):
            raise AssertionError("van_variables is not the inverse of export_classifier_state_dict")
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
            vdir, kf, msg = os.path.join(work, "videos"), os.path.join(work, "key_frames.json"), \
                os.path.join(work, "van_b0.msgpack")
            os.makedirs(vdir)
            shutil.copy(needle_mp4, os.path.join(vdir, "video1.mp4"))
            with open(kf, "w") as f:
                json.dump({"1": [PIPE_KEY_FRAME, PIPE_KEY_FRAME + 20]}, f)
            write_msgpack(tree, msg)
            argv = ["-p", vdir, "-ym", "yolo10s-seg", "-yct", repr(conf), "--imgsz", str(imgsz), "--batch", "8",
                    "--cls_model", "van_b0", "--cls_init", msg, "--crop_size", str(van_size), "--key_frames", kf]
            proto_decode.launches = 0
            t = time.perf_counter()
            devs = es.main(argv, device=dev)
            sync()
            es_s, es_launches = time.perf_counter() - t, proto_decode.launches
            ref = pipe.process_frames(list(decoded), fps=30.0, conf=conf, judge_wnd=20)
            want = compute_metrics(ref.lens, (ref.start_frame, ref.end_frame or ref.start_frame + 1),
                                   (PIPE_KEY_FRAME, PIPE_KEY_FRAME + 20), 30.0)
            from_msg = ClassifierNet("van_b0", input_size=van_size, variables=msg, device="cpu")
            msg_err = float(np.abs(from_msg._forward(x)[2].numpy() - p32).max())
        log(f"main path (evaluate_speed --cls_model van_b0 --cls_init, the needle mp4 as video1.mp4): deviations "
            f"{json.dumps(devs)} in {es_s:.1f} s, proto_decode launched {es_launches} times; the pipeline on the "
            f"decoded frames gives {[round(float(v), 6) for v in want]}; the msgpack's classifier on the CPU vs the "
            f"card's, max abs {msg_err:.3g}")
        if list(devs) != ["video1"] or not np.allclose(devs["video1"], want, rtol=1e-9, atol=1e-9):
            raise AssertionError("evaluate_speed with VAN-B0 disagrees with the pipeline on the decoded frames")
        if es_launches != -(-len(decoded) // 8) or not msg_err <= VAN_PROB_TOL:
            raise AssertionError("evaluate_speed must launch proto_decode once a batch and load the classifier whole")
        launches["proto_decode"] += es_launches
    del pipe, det

    # -- (e) ClassifierFinetuner on VAN-B0 ----------------------------------------------------------------------------
    ft_crops, ft_labels = brightness_crops(4 * van_batch, van_size, seed=41)

    def make_van(device, model=None):
        net = (ClassifierNet("van_b0", input_size=van_size, seed=0, device=device) if model is None else
               types.SimpleNamespace(model=model, device=torch.device(device), input_size=van_size))
        return ClassifierFinetuner(net, lr=5e-4, seed=0), (ft_crops, ft_labels), van_batch

    def first_van(model, arrays, bs, device):
        xx = torch.from_numpy(arrays[0]).to(device)
        return model.patch_embed1.proj, model.patch_embed1.norm, [preprocess_classifier(xx[i:i + bs], van_size)
                                                                  for i in range(0, len(xx) - bs + 1, bs)]

    ft_batches = [(torch.from_numpy(ft_crops[i:i + van_batch]), torch.from_numpy(ft_labels[i:i + van_batch]))
                  for i in range(0, len(ft_crops), van_batch)]
    ft = finetune_case(smi, f"ClassifierFinetuner VAN-B0 {van_size}^2", make_van, ft_batches, first_van, dev,
                       FT_LIMITS["van"], ft_steps)
    del van, van_cpu

    # -- (f) SAM vit_b: encoder and one decoder batch against the CPU; the generator; vit_l, vit_h -------------------
    sam = build_sam("vit_b", img_size=sam_size, device=dev)
    sam_cpu = copy.deepcopy(sam).cpu()
    image = torch.from_numpy(np.random.default_rng(50).standard_normal((1, 3, sam_size, sam_size)).astype(np.float32))
    emb = sam.encode_image(image.to(dev))
    emb_cpu = sam_cpu.encode_image(image)
    enc_err = float((emb.cpu() - emb_cpu).abs().max() / emb_cpu.abs().max())
    side = int(round(sam_batch ** 0.5))
    pts = torch.from_numpy(SamAutomaticMaskGenerator._grid(side)).float()[:, None]
    ones = torch.ones(pts.shape[:2], dtype=torch.int64)
    masks, iou = sam.decode_points(emb, pts.to(dev), ones.to(dev))
    masks_cpu, iou_cpu = sam_cpu.decode_points(emb.cpu(), pts, ones)
    dec_err = max(float((masks.cpu() - masks_cpu).abs().max() / masks_cpu.abs().max()),
                  float((iou.cpu() - iou_cpu).abs().max() / iou_cpu.abs().max()))
    log(f"SAM vit_b {sam_size}^2 on the card vs the CPU: embedding max abs {enc_err:.3g} of its largest value, "
        f"decoder batch of {len(pts)} points (from the card's embedding) {dec_err:.3g} (tol {SAM_REL_TOL})")
    if not (enc_err <= SAM_REL_TOL and dec_err <= SAM_REL_TOL):
        raise AssertionError("SAM on the card disagrees with its CPU run")
    del sam_cpu, emb_cpu, masks_cpu
    sam_ms = {"vit_b decoder batch": cuda_time_ms(lambda: sam.decode_points(emb, pts.to(dev), ones.to(dev)),
                                                  iters=5, warmup=2)}
    del masks, emb
    frame = seeded_frames(1, *sam_frame_hw, seed=51)[0][..., ::-1].copy()
    kw = dict(points_per_side=points_per_side, points_per_batch=sam_batch, crop_n_layers=1,
              crop_n_points_downscale_factor=2)
    shift = shape_sam_for_masks(sam, frame, **kw)
    first = SamAutomaticMaskGenerator(sam, **kw).generate(frame)               # warm-up, and the run compared
    gen = SamAutomaticMaskGenerator(sam, **kw)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    kept = gen.generate(frame)
    sync()
    gen_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else float("nan")
    stages = {k: v["total_s"] for k, v in gen.timer.summary().items()}
    device_s = sum(stages.get(k, 0.0) for k in ("resize", "encode", "decode"))
    n_points = points_per_side ** 2 + 4 * max(1, points_per_side // 2) ** 2
    log(f"main path (SamAutomaticMaskGenerator vit_b, crop_n_layers 1, downscale 2, {n_points} points on a "
        f"{sam_frame_hw[0]}x{sam_frame_hw[1]} frame, 5 crops encoded once each; hypernetworks x{SAM_HYPER_GAIN}, "
        f"IoU head shifted {shift:+.4f} so that {SAM_KEEP_SHARE:.0%} of the whole-frame crop's points pass): "
        f"{gen_s:.3f} s a frame, {len(kept)} masks kept at the default thresholds, equal to the warm-up run's "
        f"{same_sam_masks(kept, first)}; stages s {json.dumps(stages)} (resize, encode, decode wait for the card; "
        f"filter, nms, paste are the host's), host share {1 - device_s / gen_s:.1%}; peak memory {peak:.2f} GiB "
        f"[{smi}]")
    if not (kept and same_sam_masks(kept, first)):
        raise AssertionError("the generator kept no mask at the default thresholds, or its masks differ between "
                             "two runs on the card")
    for m in kept:
        if m["segmentation"].shape != tuple(sam_frame_hw) or m["area"] != int(m["segmentation"].sum()):
            raise AssertionError("a generated mask has the wrong shape or area")
    del first, kept, gen
    for variant in sam_types:
        model = sam if variant == "vit_b" else None
        if variant == "vit_l":
            err_buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stderr(err_buf):
                anns = segment_anything(frame, "vit_l", device=dev)
            sync()
            log(f"main path (segment_anything(frame, 'vit_l'), seeded weights): {len(anns)} masks in "
                f"{time.perf_counter() - t:.1f} s, the build included; stderr: {err_buf.getvalue().strip()}")
            if "WARNING: SAM checkpoint" not in err_buf.getvalue() or not all(
                    a["segmentation"].shape == tuple(sam_frame_hw) for a in anns):
                raise AssertionError("segment_anything did not warn of the missing checkpoint, or gave bad masks")
        if model is None:
            model = build_sam(variant, img_size=sam_size, device=dev)
        img = image.to(dev)
        emb = model.encode_image(img)
        if not bool(torch.isfinite(emb).all()) or tuple(emb.shape) != (1, 256, sam_size // 16, sam_size // 16):
            raise AssertionError(f"SAM {variant}: bad embedding {tuple(emb.shape)}")
        sam_ms[variant] = cuda_time_ms(lambda: model.encode_image(img), iters=3, warmup=1)
        flops, nbytes = sam_encoder_work(variant, sam_size)
        bound, by = roofline_ms(f"SAM {variant} encoder {sam_size}^2, fp32 (TF32 off)", nbytes, flops, FP32_FLOP_PER_S)
        log(f"SAM {variant} encoder {sam_size}^2: {sam_ms[variant]:.3f} ms (CUDA events, mean of 3), "
            f"{flops / 1e12:.4f} TFLOP, bound {bound:.3f} ms by {by}: {bound / sam_ms[variant]:.1%} of it [{smi}]")
        del model, emb
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    del sam
    log(f"phase 3z (VAN, SAM): {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return launches


def sync() -> None:
    """Wait for the card (a no-op without one: the phases rehearse on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


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
    if sorted(built) != ["decode_tail", "memory_readout", "proto_decode"]:  # proto_decode holds both types
        raise AssertionError(f"expected three kernel sources, found {built}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # -- 2. kernels against their plain versions -------------------------------
    net = needle_network(device)
    readout_err = check_memory_readout(device)
    tail_err = check_decode_tail(net, device)
    # the backward of both (training): against the port's CPU path and a float64 run on the card
    grad_share = {"memory_readout": max(check_readout_grad_case(c, device, 500 + i)
                                        for i, c in enumerate(READOUT_GRAD_CASES)),
                  "decode_tail": max(check_tail_grad_case(net, c, device, 520 + i)
                                     for i, c in enumerate(TAIL_GRAD_CASES))}
    log(f"backward of the tracker's kernels within their limits: {json.dumps(grad_share)}")
    proto_err = check_proto_decode(device)
    max_err = {"proto_decode": proto_err[torch.float32],
               "proto_decode_bf16": proto_err[BF16],
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

    # -- 3e. the bf16 detector: predict, held to the fp32 detector above --------------------------
    det16 = YOLO("yolo10s-seg", nc=1, seed=0, dtype=torch.bfloat16)
    proto_decode.launches = proto_decode.launches_bf16 = 0
    res16_plain = det16.predict(list(frames), conf=conf, imgsz=imgsz, retina_masks=False)
    res16_retina = det16.predict(list(frames), conf=conf, imgsz=imgsz, retina_masks=True)
    torch.cuda.synchronize()
    launches["proto_decode_bf16"] = proto_decode.launches_bf16
    log(f"main path (predict, bf16): proto_decode_bf16 launched {proto_decode.launches_bf16} times, "
        f"the fp32 kernel {proto_decode.launches}")
    if proto_decode.launches_bf16 <= 0 or proto_decode.launches:
        raise AssertionError("the bf16 detector must decode through proto_decode_bf16 and only through it")
    for name, res16, res in (("non-retina", res16_plain, res_plain), ("retina", res16_retina, res_retina)):
        counts, px = check_results(res16, n_frames, h0, w0)
        log(f"bf16 {name}: detections per frame {counts} (fp32: {[len(r) for r in res]}), mask pixels {px}")
    head = head_bf16_vs_fp32(det, det16, frames, imgsz)
    log(f"bf16 vs fp32 detector head on the card, mean abs diff over every anchor: {json.dumps(head)} "
        f"(limits: scores {DET_BF16_SCORE_MEAN}, boxes {DET_BF16_BOX_MEAN_PX} px)")
    if not (head["probs"] <= DET_BF16_SCORE_MEAN and head["boxes"] <= DET_BF16_BOX_MEAN_PX):
        raise AssertionError("the bf16 detector is farther from the fp32 one than its limits")

    # -- 3f. the speed pipeline with the bf16 detector and classifier ---------------------------------
    pipe16 = VideoSpeedPipeline(YOLO("yolo10s-seg", nc=1, seed=0, dtype=torch.bfloat16),
                                ClassifierNet("efficientnet_b3", seed=0, dtype=torch.bfloat16),
                                device_batch=8, imgsz=imgsz, crop_size=380)
    pipe16_conf, gap16 = pipeline_conf(pipe16, clip)
    proto_decode.launches = proto_decode.launches_bf16 = 0
    pipe16_out = pipe16.process_frames(list(clip), fps=30.0, conf=pipe16_conf)
    torch.cuda.synchronize()
    launches["proto_decode_bf16"] += proto_decode.launches_bf16
    summary16 = check_pipeline_output(pipe16_out, PIPE_FRAMES, h0, w0)
    log(f"main path (speed pipeline, bf16 YOLOv10-S and B3, conf {pipe16_conf:.6f} in a gap of {gap16:.3g}): "
        f"proto_decode_bf16 launched {proto_decode.launches_bf16} times for {n_batches} batches; {json.dumps(summary16)}")
    if proto_decode.launches_bf16 != n_batches or proto_decode.launches:
        raise AssertionError("the bf16 pipeline must launch proto_decode_bf16 once a batch")
    # its device step against the fp32 step on the same batch and conf (the first batch)
    s32, s16 = pipeline_step_numpy(pipe, clip[:8], 0.0), pipeline_step_numpy(pipe16, clip[:8], 0.0)
    step_diff = {"conf": float(np.abs(s16["conf"] - s32["conf"]).mean()),
                 "cls_prob": float(np.abs(s16["cls_prob"] - s32["cls_prob"]).mean())}
    log(f"pipeline step bf16 vs fp32 on the card, first batch at conf 0, mean abs diff: {json.dumps(step_diff)} "
        f"(limits: best score {STEP_BF16_CONF_MEAN}, classifier probability {CLS_BF16_PROB_MEAN})")
    if not (step_diff["conf"] <= STEP_BF16_CONF_MEAN and step_diff["cls_prob"] <= CLS_BF16_PROB_MEAN):
        raise AssertionError("the bf16 pipeline step is farther from the fp32 one than its limits")

    # -- 3g. the bench's fused seg+track step at B 128 ---------------------------------------------------
    from yolo_puncture_tpu_torch import bench as bm

    mr.memory_readout.launches = dt.decode_tail.launches = 0
    proto_decode.launches = proto_decode.launches_bf16 = 0
    t = time.perf_counter()
    bench_res, bench_details = bm.run_bench(BENCH_BATCH, BENCH_ITERS, imgsz, track=True,
                                            trace_dir=os.path.join(ROOT, "build", "bench_trace"))
    torch.cuda.synchronize()
    n_steps = BENCH_ITERS + 2                                     # warm-up, timed, traced
    bench_launches = (proto_decode.launches_bf16, mr.memory_readout.launches, dt.decode_tail.launches)
    log(f"main path (bench, B {BENCH_BATCH} {h0}x{w0}, bf16 YOLOv10-S seg at {imgsz}^2 + bf16 tracker at 480x864, "
        f"2 slots, window 4, exact): {n_steps} steps launched proto_decode_bf16 {bench_launches[0]}, memory_readout "
        f"{bench_launches[1]}, decode_tail {bench_launches[2]} times (fp32 proto_decode {proto_decode.launches}); "
        f"steps ms {[round(v, 3) for v in bench_details['steps_ms']]}, checksum {bench_details['chk']}; "
        f"{time.perf_counter() - t:.1f} s with the build [{smi}]")
    if bench_launches != (n_steps, n_steps * BENCH_BATCH // 4, n_steps) or proto_decode.launches:
        raise AssertionError(f"the bench step launched {bench_launches}, not one decode, 32 readouts and one tail")
    if not np.isfinite(bench_details["chk"]):
        raise AssertionError("the bench's checksum is not finite")
    launches["proto_decode_bf16"] += bench_launches[0]
    launches["memory_readout_bf16"] += bench_launches[1]
    launches["decode_tail_bf16"] += bench_launches[2]
    print(smi, flush=True)
    print(json.dumps(bench_res), flush=True)

    # -- 3h. tracker quality on the shipped checkpoint: the protocol in fp32 and bf16 --------------------
    from yolo_puncture_tpu_torch.track import quality

    t = time.perf_counter()
    mr.memory_readout.launches = 0
    qual = quality.run_protocol()
    log(f"tracker quality (16 clips x 32 frames at 240x432, tracker_propagation.msgpack): {json.dumps(qual)}; "
        f"memory_readout launched {mr.memory_readout.launches} times; {time.perf_counter() - t:.1f} s [{smi}]")
    for row, q in qual.items():
        if not abs(q["mean_iou"] - q["jax_mean_iou"]) <= QUALITY_TOL:
            raise AssertionError(f"tracker quality row {row}: {q['mean_iou']} is not within {QUALITY_TOL} of "
                                 f"the JAX package's {q['jax_mean_iou']}")

    # -- 3i. the tracking app (apps/track_video.py) at full width -------------------------------------------
    from yolo_puncture_tpu_torch.ops.resize import resize_nearest

    tv_frames, tv_masks = bar_frames(TV_FRAMES, h0, w0, seed=4)
    tv_root = os.path.join(ROOT, "build", "track_video")
    tv_model = os.path.join(tv_root, "model", "yolo10s-seg")      # no such file: the seeded init, its sidecar beside it
    tv_mid, tv_gap = app_calibration(os.path.dirname(tv_model), tv_frames, 480, imgsz)
    log(f"track_video: calibration.json puts the app's conf 0.9 at raw score {tv_mid:.6f}, in a gap of {tv_gap:.3g} "
        f"between the clip's best scores")
    tv_base = ["--video_name", "bar", "--img_path", "decoded-frames", "--model", tv_model, "--imgsz", str(imgsz),
               "--tracker_weights", NEEDLE]
    tv_runs = [  # (name, flags, the kernels its path must launch)
        ("online, long-term off", ["--temporal_setting", "online", "--disable_long_term"],
         ("proto_decode", "memory_readout", "decode_tail")),
        ("semionline, align_voting propagate", ["--align_voting", "propagate"], ("proto_decode", "decode_tail")),
        ("semionline, align_voting affinity", ["--align_voting", "affinity"], ("proto_decode", "decode_tail")),
        ("semionline, batch_propagation, long-term off", ["--batch_propagation", "--disable_long_term"],
         ("proto_decode", "memory_readout", "decode_tail")),
        ("online, --amp, long-term off", ["--temporal_setting", "online", "--disable_long_term", "--amp"],
         ("proto_decode_bf16", "memory_readout_bf16", "decode_tail_bf16")),
    ]
    tv_segments = 0                     # segments saved over the YOLO runs
    for i, (name, flags, needs) in enumerate(tv_runs):
        for detector, what in ((None, "YOLOv10-S seg"), (BarDetector(), "bar detector")):
            out_dir = os.path.join(tv_root, f"run{i}" + ("_bar" if detector else ""))
            mr.memory_readout.launches = dt.decode_tail.launches = 0
            proto_decode.launches = proto_decode.launches_bf16 = 0
            run = run_track_app(tv_base + flags + ["--output", out_dir], tv_frames, detector)
            bf16 = "--amp" in flags
            got = {("proto_decode_bf16" if bf16 else "proto_decode"):
                   proto_decode.launches_bf16 if bf16 else proto_decode.launches,
                   ("memory_readout_bf16" if bf16 else "memory_readout"): mr.memory_readout.launches,
                   ("decode_tail_bf16" if bf16 else "decode_tail"): dt.decode_tail.launches}
            n_seg = [len(a["segments_info"]) for a in run["pred"]["annotations"]]
            iou = [round(float(((ids > 0) & m).sum() / max(((ids > 0) | m).sum(), 1)), 4) for ids, m in
                   zip(run["ids"], (resize_nearest(m.astype(np.uint8), run["tracker"].image_size) > 0
                                    for m in tv_masks))]
            log(f"main path (track_video {name}, {what}, {TV_FRAMES} frames {h0}x{w0}, tracker "
                f"{run['tracker'].image_size}, long-term {run['cfg']['enable_long_term']}): launches {json.dumps(got)}; "
                f"{run['detector_calls']} detector calls; segments per frame {n_seg}; IoU of the tracked ids with "
                f"the bar {iou}; {run['ms']:.1f} ms")
            for k in needs:
                if detector is not None and k.startswith("proto_decode"):
                    continue
                if got.get(k, 0) <= 0:
                    raise AssertionError(f"track_video ({name}, {what}) did not launch {k}")
                launches[k] += got[k]
            if detector is not None:
                if min(iou) < TV_BAR_IOU or sorted(run["tracker"].object_manager.all_obj_ids) != [1]:
                    raise AssertionError(f"track_video ({name}) lost the bar: IoU {iou}, ids "
                                         f"{run['tracker'].object_manager.all_obj_ids}")
            else:
                tv_segments += sum(n_seg)
    if tv_segments == 0:
        raise AssertionError("track_video with YOLOv10-S seg tracked nothing: the calibrated detector found nothing")
    # per-frame times on the host clock, fp32 and --amp in turns, each after the runs above
    tv_times = {}
    for name, flags in (("online, long-term off", ["--temporal_setting", "online", "--disable_long_term"]),
                        ("semionline (the app's defaults)", [])):
        for dtype_flags in ([], ["--amp"], ["--amp"], []):
            run = run_track_app(tv_base + flags + dtype_flags + ["--output", os.path.join(tv_root, "timed")],
                                tv_frames)
            key = f"{name}, {'bf16' if dtype_flags else 'fp32'}"
            tv_times.setdefault(key, []).append(
                {k: round(run[k] / TV_FRAMES, 3) for k in ("ms", "detector_ms", "saver_ms")})
    for key, runs in tv_times.items():
        log(f"track_video {key}: per frame ms (whole, detector, saver) {runs}; "
            f"{1e3 / np.mean([r['ms'] for r in runs]):.2f} frames/s [{smi}]")

    # -- 3j. the batch speed CLI (apps/auto_speed_calc.py): its pipeline over the needle clip ----------------
    from yolo_puncture_tpu_torch.apps import auto_speed_calc as asc

    asc_pipe = asc.build_pipeline(os.path.join(tv_root, "asc_model", "yolo10s-seg"), "no-such-classifier.pth.tar",
                                  16, imgsz)
    asc_conf, asc_gap = pipeline_conf(asc_pipe, clip)
    proto_decode.launches = proto_decode.launches_bf16 = 0
    t = time.perf_counter()
    asc_out = asc_pipe.process_frames(list(clip), fps=30.0, conf=asc_conf, judge_wnd=20)
    torch.cuda.synchronize()
    asc_ms = (time.perf_counter() - t) * 1e3
    n_asc = -(-PIPE_FRAMES // 16)
    log(f"main path (auto_speed_calc's pipeline: bf16 YOLOv10-S seg and B3, batch 16, conf {asc_conf:.6f} in a gap "
        f"of {asc_gap:.3g}): proto_decode_bf16 launched {proto_decode.launches_bf16} times for {n_asc} batches; "
        f"{asc_ms:.1f} ms; {json.dumps(check_pipeline_output(asc_out, PIPE_FRAMES, h0, w0))}")
    print(asc.speed_line("needle", asc_out), flush=True)
    if proto_decode.launches_bf16 != n_asc or proto_decode.launches:
        raise AssertionError("auto_speed_calc's pipeline must launch proto_decode_bf16 once a batch")
    launches["proto_decode_bf16"] += proto_decode.launches_bf16
    del asc_pipe

    # -- 3k. the host geometry in C++ against its numpy versions, on the pipeline's masks -------------------
    geo_raws, _, _ = pipe._run(((0, f) for f in clip), 1, pipe_conf)
    geo = app_geometry(geo_raws[0])
    log(f"host geometry over the {geo['frames']} detected frames of the needle clip (letterbox masks, "
        f"{geo['points']} polygon points median): numpy tracer and calipers {geo['numpy_ms_per_frame']:.4f} ms a "
        f"frame, C++ {geo['native_ms_per_frame']:.4f} ms a frame; polygons equal, lengths equal [{smi}]")

    # -- 3l. the HTTP server (apps/serve.py): 32 PNG uploads from 16 clients, batched -----------------------
    import contextlib
    import importlib.util
    import io

    from yolo_puncture_tpu_torch.apps import app as app_mod
    from yolo_puncture_tpu_torch.apps import serve, webui, yolo_cli
    from yolo_puncture_tpu_torch.utils.png import decode_png, encode_png_rgb

    serve_frames = seeded_frames(SERVE_FRAMES, h0, w0, seed=6)
    pngs = [encode_png_rgb(f[..., ::-1]) for f in serve_frames]
    queries = [f"?conf={conf}&retina={i % 2}&max_polygon={(-1, 0, 2)[i % 3]}" for i in range(SERVE_FRAMES)]
    server = serve.Server(det, host="127.0.0.1", port=0, imgsz=imgsz, max_batch=16, window_ms=5.0).start()
    try:
        health = json.loads(http_get(f"http://127.0.0.1:{server.port}/healthz")[1])
        if health != {"status": "ok", "platform": "gpu"}:
            raise AssertionError(f"/healthz answered {health}")
        drive_server(server, pngs[:SERVE_CLIENTS], queries[:SERVE_CLIENTS])     # warm-up: the batch shapes
        stats0 = json.loads(http_get(f"http://127.0.0.1:{server.port}/stats")[1])
        proto_decode.launches = proto_decode.launches_bf16 = 0
        t = time.perf_counter()
        responses, latency = drive_server(server, pngs, queries)
        serve_s = time.perf_counter() - t
        torch.cuda.synchronize()
        launches["proto_decode_serve"] = proto_decode.launches
        stats = json.loads(http_get(f"http://127.0.0.1:{server.port}/stats")[1])
        bad = http_post(f"http://127.0.0.1:{server.port}/predict", b"not an image", "image/png")
        if importlib.util.find_spec("cv2") is not None:     # a JPEG through cv2, and refused where cv2 is missing
            import cv2

            jpeg_bytes = cv2.imencode(".jpg", serve_frames[0])[1].tobytes()
            jpeg_cv2 = http_post(f"http://127.0.0.1:{server.port}/predict?conf={conf}", jpeg_bytes, "image/jpeg")
            jpeg_ref = serve.result_json(det.predict([cv2.imdecode(np.frombuffer(jpeg_bytes, np.uint8),
                                                                   cv2.IMREAD_COLOR)], conf=conf, imgsz=imgsz)[0],
                                         1, -1)
            if jpeg_cv2[0] != 200:
                raise AssertionError(f"a JPEG with cv2 installed got {jpeg_cv2}")
            same_serve_json(jpeg_cv2[1], jpeg_ref, (h0, w0))
            saved_cv2 = sys.modules["cv2"]
            sys.modules["cv2"] = None                          # the handler's 'import cv2' now raises
            try:
                jpeg = http_post(f"http://127.0.0.1:{server.port}/predict", jpeg_bytes, "image/jpeg")
            finally:
                sys.modules["cv2"] = saved_cv2
        else:
            jpeg = http_post(f"http://127.0.0.1:{server.port}/predict", b"\xff\xd8\xff\xe0\x00\x10JFIF\x00"
                             + bytes(64), "image/jpeg")
    finally:
        server.stop()
    batches = stats["batches"] - stats0["batches"]
    mean_batch = (stats["batched_frames"] - stats0["batched_frames"]) / max(batches, 1)
    log(f"main path (serve, {SERVE_FRAMES} PNG uploads of {h0}x{w0} from {SERVE_CLIENTS} clients, retina and not, "
        f"max_polygon -1/0/2): proto_decode launched {launches['proto_decode_serve']} times over {batches} device "
        f"batches, mean padded batch {mean_batch:.2f} (/stats {json.dumps(stats)}); request latency ms p50 "
        f"{np.percentile(latency, 50):.1f} p99 {np.percentile(latency, 99):.1f}, {SERVE_FRAMES / serve_s:.2f} "
        f"requests/s [{smi}]")
    if launches["proto_decode_serve"] <= 0 or proto_decode.launches_bf16:
        raise AssertionError("the server did not decode its masks through proto_decode")
    if not mean_batch > 1:
        raise AssertionError(f"the server did not batch: mean batch {mean_batch}")
    if bad != (400, {"error": "could not decode image"}):
        raise AssertionError(f"garbage bytes got {bad}")
    if jpeg != (400, {"error": "could not decode image"}):
        raise AssertionError(f"a JPEG without cv2 got {jpeg}")
    n_exact = n_boxes = 0
    for (code, got), frame, q, i in zip(responses, serve_frames, queries, range(SERVE_FRAMES)):
        if code != 200 or "error" in got:
            raise AssertionError(f"request {i} answered {code} {got}")
        retina, max_polygon = i % 2 == 1, (-1, 0, 2)[i % 3]
        ref = serve.result_json(det.predict([frame], conf=conf, retina_masks=retina, imgsz=imgsz)[0], got["batch"],
                                max_polygon)
        n_exact += same_serve_json(got, ref, (h0, w0))
        n_boxes += len(got["boxes"])
    log(f"serve responses against a direct predict of each frame: {n_exact} of {SERVE_FRAMES} equal to the last "
        f"digit, the others within a rounding step (boxes {SERVE_BOX_TOL}, scores {SERVE_CONF_TOL}, polygons "
        f"filled to {SERVE_POLY_AREA_AGREE} of the same pixels); {n_boxes} boxes; garbage -> {bad[0]}, "
        f"a JPEG without cv2 -> {jpeg[0]} ("
        f"{'cv2 installed: with it, a JPEG -> 200' if importlib.util.find_spec('cv2') else 'cv2 absent'})")
    if n_boxes == 0:
        raise AssertionError("the served frames gave no detections")
    launches["proto_decode"] += launches.pop("proto_decode_serve")

    # -- 3m. yolo_cli predict over a directory of PNG files -------------------------------------------------
    cli_dir = os.path.join(ROOT, "build", "cli_pngs")
    os.makedirs(cli_dir, exist_ok=True)
    for i in range(4):
        with open(os.path.join(cli_dir, f"frame{i}.png"), "wb") as f:
            f.write(pngs[i])
    names = sorted(os.listdir(cli_dir))
    proto_decode.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        yolo_cli.main(["predict", "model=yolo10s-seg", f"source={cli_dir}", f"conf={conf}", f"imgsz={imgsz}"])
    torch.cuda.synchronize()
    cli_launches = proto_decode.launches
    want = []
    for name, r in zip(names, det.predict([serve_frames[int(n[5])] for n in names], conf=conf, imgsz=imgsz,
                                          retina_masks=True)):
        want.append(f"{os.path.join(cli_dir, name)}: {len(r.boxes)} instances")
        want += [f"  cls={int(r.boxes.cls[i])} conf={r.boxes.conf[i]:.3f} xyxy={r.boxes.xyxy[i].round(1).tolist()}"
                 for i in range(len(r.boxes))]
    got_lines = buf.getvalue().splitlines()
    log(f"main path (yolo_cli predict, {len(names)} PNG files): proto_decode launched {cli_launches} times; "
        f"{len(got_lines)} lines, first: {got_lines[:2]}")
    if got_lines != want or cli_launches <= 0:
        raise AssertionError(f"yolo_cli predict printed {got_lines}, a direct predict gives {want}")
    launches["proto_decode"] += cli_launches

    # -- 3n. the app's yolo_inference: image mode, then video mode on decoded frames ------------------------
    app_image = np.ascontiguousarray(serve_frames[5][..., ::-1])                       # RGB, as gradio hands it
    app_det = app_mod.build_detector("seg/yolo11n-seg-finetune.pt")            # no such file: the seeded YOLO11n
    best = float(app_det.predict(app_image, conf=0.0, imgsz=imgsz)[0].boxes.conf.max())
    app_conf = round(best * 0.95, 6)
    proto_decode.launches = 0
    t = time.perf_counter()
    app_img, _, app_info = app_mod.yolo_inference(app_image, None, yolo_conf_threshold=app_conf, imgsz=imgsz,
                                                  return_info=True)
    app_ms = (time.perf_counter() - t) * 1e3
    image_launches = proto_decode.launches
    log(f"main path (yolo_inference image mode, seeded YOLO11n seg at {imgsz}^2 with retina masks, conf {app_conf}): "
        f"proto_decode launched {image_launches} times; {json.dumps(app_info)}; {app_ms:.1f} ms with the model's "
        f"build [{smi}]")
    if image_launches <= 0 or app_info["detections"] <= 0 or app_img.shape != app_image.shape:
        raise AssertionError("yolo_inference's image mode found nothing or did not launch proto_decode")
    if not (app_img != app_image).any():
        raise AssertionError("yolo_inference's image mode drew no mask")
    vpipe, vunet = app_mod.build_video_models(app_det, "u2netp_finetune_70.pth",
                                              "EfficientNet/efficientnet_b3.pth.tar", 8, imgsz, 380)
    vconf, vgap = pipeline_conf(vpipe, clip)
    timed_unet = TimedUNet(vunet)
    app_mod.annotate_video(list(clip[:8]), 30.0, vpipe, timed_unet, vconf, 20, 380)           # warm-up
    timed_unet.ms, timed_unet.calls = 0.0, 0
    proto_decode.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    annotated, vinfo = app_mod.annotate_video(list(clip), 30.0, vpipe, timed_unet, vconf, 20, 380)
    video_ms = (time.perf_counter() - t) * 1e3
    video_launches = proto_decode.launches
    ref_out = vpipe.process_frames(list(clip), 30.0, conf=vconf, judge_wnd=20)
    log(f"main path (yolo_inference video mode on the {PIPE_FRAMES} decoded needle frames: seeded YOLO11n seg, B3 "
        f"and U2NETP on 380^2 crops, device_batch 8, conf {vconf:.6f} in a gap of {vgap:.3g}): proto_decode launched "
        f"{video_launches} times; {json.dumps(vinfo)}; {PIPE_FRAMES / video_ms * 1e3:.1f} frames/s, U2NETP "
        f"{timed_unet.ms:.1f} of {video_ms:.1f} ms ({timed_unet.ms / video_ms:.1%}, {timed_unet.calls} calls) [{smi}]")
    if video_launches != n_batches:
        raise AssertionError(f"the app's video mode launched proto_decode {video_launches} times for {n_batches} "
                             "batches")
    if (vinfo["start_frame"], vinfo["end_frame"], vinfo["speed_mm_s"]) != (
            ref_out.start_frame, ref_out.end_frame, ref_out.speed_mm_s):
        raise AssertionError(f"the app's video mode measured {vinfo}, the pipeline {ref_out.start_frame}, "
                             f"{ref_out.end_frame}, {ref_out.speed_mm_s}")
    if len(annotated) != PIPE_FRAMES or timed_unet.calls != PIPE_FRAMES or not any(
            (a != f).any() for a, f in zip(annotated, clip)):
        raise AssertionError("the app's video mode did not annotate every frame")
    launches["proto_decode"] += image_launches + video_launches
    del vpipe, vunet, timed_unet, annotated

    # -- 3o. the web UI (apps/webui.py): image mode over HTTP, a multipart PNG -------------------------------
    ui = webui.WebUI(host="127.0.0.1", port=0, imgsz=imgsz).start()
    try:
        body, ctype = multipart({"mode": "image", "conf": app_conf}, "frame.png", pngs[5])
        proto_decode.launches = 0
        code, ui_info = http_post(f"http://127.0.0.1:{ui.port}/analyze", body, ctype)
        ui_launches = proto_decode.launches
        if code != 200:
            raise AssertionError(f"the web UI answered {code} {ui_info}")
        mime, ui_png = http_get(f"http://127.0.0.1:{ui.port}{ui_info['output_url']}")
    finally:
        ui.stop()
    ui_img = decode_png(ui_png)
    log(f"main path (web UI /analyze, image mode, a multipart PNG of {h0}x{w0}): proto_decode launched {ui_launches} "
        f"times; {json.dumps(ui_info)}; {mime} of {len(ui_png)} bytes")
    if ui_launches <= 0 or mime != "image/png":
        raise AssertionError("the web UI did not launch proto_decode or did not answer with a PNG")
    if {k: v for k, v in ui_info.items() if k != "output_url"} != app_info or not np.array_equal(
            ui_img, app_img[..., ::-1]):
        raise AssertionError("the web UI's info or annotated pixels differ from yolo_inference's")
    launches["proto_decode"] += ui_launches
    del app_det

    # -- 3p. the bench with --shared (the tracker reads the detector's pyramid), in turns with the default ---
    shared_lines = {}
    for shared in (True, False):
        mr.memory_readout.launches = dt.decode_tail.launches = 0
        proto_decode.launches = proto_decode.launches_bf16 = 0
        res, details = bm.run_bench(BENCH_BATCH, BENCH_ITERS, imgsz, track=True, shared=shared)
        torch.cuda.synchronize()
        n_steps = BENCH_ITERS + 1
        got = (proto_decode.launches_bf16, mr.memory_readout.launches, dt.decode_tail.launches)
        log(f"main path (bench{' --shared' if shared else ''}, B {BENCH_BATCH}): {n_steps} steps launched "
            f"proto_decode_bf16 {got[0]}, memory_readout {got[1]}, decode_tail {got[2]} times; steps ms "
            f"{[round(v, 3) for v in details['steps_ms']]}, checksum {details['chk']} [{smi}]")
        if got != (n_steps, n_steps * BENCH_BATCH // 4, n_steps) or proto_decode.launches:
            raise AssertionError(f"the bench step launched {got}, not one decode, 32 readouts and one tail")
        if not np.isfinite(details["chk"]):
            raise AssertionError("the bench's checksum is not finite")
        if shared:
            launches["proto_decode_bf16"] += got[0]
            launches["memory_readout_bf16"] += got[1]
            launches["decode_tail_bf16"] += got[2]
        shared_lines["shared" if shared else "default"] = res
    for name, res in shared_lines.items():
        log(f"bench {name}:")
        print(json.dumps(res), flush=True)

    # -- 3q-3s. training: the tracker's trainer, the detector's Trainer, their entry points ---------------
    import tempfile

    for k, n in train_tracker_phase(smi).items():
        launches[k] += n
    train_detector_phase(smi, imgsz)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        for k, n in train_apps_phase(work, imgsz).items():
            launches[k] += n
        # -- 3t. the fine-tuners; 3u. yolo_cli calibrate on 3s's checkpoint; 3v. yolo_cli export --------------
        finetune_phase(smi)
        launches["proto_decode"] += calibrate_phase(work, smi, imgsz)
        export_phase(work, smi, imgsz)

    # -- 3w. the bench's other modes: e2e, e2e_device, unfused, long-term ------------------------------------
    for k, n in bench_modes_phase(smi, imgsz).items():
        launches[k] += n

    # -- 3x. video files: mp4 written with cv2 and read by the pipeline, the tracking app and the app ---------
    tv_argv = ["--video_name", "bar", "--model", tv_model, "--imgsz", str(imgsz), "--tracker_weights", NEEDLE,
               "--temporal_setting", "online", "--disable_long_term"]
    video_launches, needle_mp4, needle_decoded = video_phase(smi, pipe, pipe_conf, clip, tv_argv, tv_frames, vconf,
                                                             imgsz)
    for k, n in video_launches.items():
        launches[k] += n

    # -- 3y. int8: one convolution, predict, serve, the int8 ring, the bench's int8 modes ---------------------
    for k, n in int8_phase(smi, frames, needle_mp4, needle_decoded, serve_frames, pngs, queries, probs, track_frames,
                           track_masks, conf=conf, imgsz=imgsz).items():
        launches[k] += n

    # -- 3z. the rest of the model zoo: VAN (classifier, pipeline, evaluate_speed, fine-tuner) and SAM -----------
    for k, n in zoo_phase(smi, clip, needle_decoded, needle_mp4, imgsz=imgsz).items():
        launches[k] += n

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
    # than max_masks detections (predictor.py _overflow: B 1, N max_masks); eight frames; sixteen,
    # the server's largest padded batch
    for Bt in (B, 1, 8, 16):
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
        args_aff = mr.kernel_args(q, k, v, ok, out, scratch, n_split, affinity_bf16=True)
        ms_aff = cuda_time_ms(lambda: launch(*args_aff), iters=20, warmup=3)
        ms2 = cuda_time_ms(lambda: launch(*args), iters=20, warmup=3)     # again, after the others
        n_valid = int(ok.sum())
        esize = q.element_size()
        flops = 2 * Q * n_valid * (64 + No * Cv)
        bytes_moved = esize * (Q * 64 + n_valid * 64 + No * n_valid * Cv + No * Q * Cv) + M
        log(f"memory_readout Q={Q} M={M} ({n_valid} valid) No={No} Cv={Cv} {str(dtype)[6:]} splits={n_split}: "
            f"kernel {ms:.4f} ms (again {ms2:.4f}; with affinity_bf16 {ms_aff:.4f}; wrapper {wrapper:.4f}), "
            f"plain {plain:.4f} ms, dense two-matmul "
            f"{dense:.4f} ms, yardstick [{what}] {lib:.4f} ms, ({bytes_moved} B, {flops} FLOP) [{smi}]")
        # fp32 goes through the tensor cores as three TF32 products for every fp32 product
        name, ops, rate = (("memory_readout", 3 * flops, TF32_FLOP_PER_S) if dtype == torch.float32 else
                           ("memory_readout_bf16", flops, BF16_FLOP_PER_S))
        if keep:
            kernels.append(kernel_entry(name, "memory_readout", "yolo_puncture_tpu/ops/pallas/mem_attention.py:24",
                                        launches[name], max_err[name], ms, plain, lib, bytes_moved, ops, rate))
            kernels[-1].update(affinity_bf16_max_abs_err=readout_err[("affinity_bf16", dtype)],
                               affinity_bf16_ms=ms_aff)
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

    # -- 6f. proto_decode_bf16 at its launch shapes: the bench's, the pipeline's, predict's --------------
    for Bt, N, crop, what in ((BENCH_BATCH, 1, False, "the bench's launch"), (8, 1, False, "the pipeline's launch"),
                              (4, 32, True, "predict's launch")):
        r = proto_decode_bf16_times(Bt, N, Hp, Wp, crop, device)
        bound, _ = roofline_ms(f"proto_decode_bf16 B={Bt} N={N} ({what})", r["bytes"], r["flops"], FP32_FLOP_PER_S)
        tk, tm = r["times"]["kernel"], r["times"]["matmul"]
        order = ("every kernel repeat is below every matmul repeat" if tk[-1] < tm[0] else
                 "every matmul repeat is below every kernel repeat" if tm[-1] < tk[0] else "the repeats overlap")
        log(f"proto_decode_bf16 B={Bt} N={N} {Hp}x{Wp} soft crop={crop} ({what}), ms over 5 repeats of 200 launches "
            f"from Python: " + "; ".join(f"{n} min {t[0]:.5f} median {t[2]:.5f} max {t[-1]:.5f}"
                                         for n, t in r["times"].items())
            + f"; {order}; replayed from a CUDA graph of 20: "
            + "; ".join(f"{n} min {t[0]:.5f} median {t[2]:.5f} max {t[-1]:.5f}" for n, t in r["graph"].items())
            + f"; {bound / tk[2]:.1%} of the bound launched, {bound / r['graph']['kernel'][2]:.1%} in a graph "
            f"({r['bytes']} B, {r['flops']} FLOP) [{smi}]")
        if Bt == BENCH_BATCH:
            kernels.append(kernel_entry("proto_decode_bf16", "proto_decode",
                                        "yolo_puncture_tpu/ops/pallas/proto_decode.py:23",
                                        launches["proto_decode_bf16"], max_err["proto_decode_bf16"], tk[2],
                                        r["times"]["plain"][2], tm[2], r["bytes"], r["flops"], FP32_FLOP_PER_S))

    # -- 6g. bf16 against fp32 on the host clock: predict, the pipeline; the bench's stages -------------
    for retina in (False, True):
        t32 = host_ms(lambda: det.predict(list(frames), conf=conf, imgsz=imgsz, retina_masks=retina))
        t16 = host_ms(lambda: det16.predict(list(frames), conf=conf, imgsz=imgsz, retina_masks=retina))
        log(f"predict B={B} retina={retina}, ms (3 each, fp32 then bf16): fp32 {sorted(t32)[1]:.1f} ({t32}), "
            f"bf16 {sorted(t16)[1]:.1f} ({t16}) [{smi}]")
        stages16 = predict_stage_ms(det16, list(frames), conf=conf, imgsz=imgsz, retina_masks=retina)
        log(f"predict bf16 stages ms, synchronised, retina={retina}: {json.dumps(stages16)}")
    pipe16.process_frames(list(clip), fps=30.0, conf=pipe16_conf)  # warm-up
    runs = {}
    for name, p, c in (("fp32", pipe, pipe_conf), ("bf16", pipe16, pipe16_conf), ("bf16 ", pipe16, pipe16_conf),
                       ("fp32 ", pipe, pipe_conf)):
        runs.setdefault(name.strip(), []).extend(host_ms(lambda: p.process_frames(list(clip), fps=30.0, conf=c)))
    log("pipeline 67 frames, in turns fp32, bf16, bf16, fp32 (3 calls each turn), frames/s: "
        + "; ".join(f"{n} median {PIPE_FRAMES / np.median(v) * 1e3:.1f} ({[round(x, 1) for x in v]} ms)"
                    for n, v in runs.items()) + f" [{smi}]")
    stages16 = pipeline_stage_ms(pipe16, clip, pipe16_conf)
    log(f"pipeline bf16 stages ms over the clip ({n_batches} batches), synchronised: "
        f"{json.dumps({k: round(v, 3) for k, v in stages16.items()})} [{smi}]")
    del pipe16, det16
    model16, btracker = bm.bench_models(imgsz, True, device=device)
    bframes = torch.from_numpy(bm.seeded_frames(BENCH_BATCH)).to(device)
    core = btracker[1].core                                          # the readout reads its flag at each call
    for aff in (True, False):                                        # warm-up
        core.affinity_bf16 = aff
        bench_stage_ms(model16, btracker, bframes, imgsz)
    for i, aff in enumerate((True, False, False, True)):
        core.affinity_bf16 = aff
        steps = bench_steps_ms(model16, btracker, bframes, imgsz)
        stages = bench_stage_ms(model16, btracker, bframes, imgsz)
        log(f"bench step B {BENCH_BATCH} with affinity_bf16={aff} (turn {i + 1} of on, off, off, on): steps ms "
            f"{[round(v, 3) for v in steps]} (CUDA events, unclocked); stages ms, synchronised: "
            f"{json.dumps({k: round(v, 3) for k, v in stages.items()})} [{smi}]")
    core.affinity_bf16 = True
    del model16, btracker, bframes, core

    # -- 6h. the backward of the tracker's kernels at the trainer's shapes, beside their forward -----------
    for name, make in (("memory_readout", lambda: readout_grad_inputs(READOUT_GRAD_CASES[0], device, 600)),
                       ("decode_tail", lambda: (*tail_inputs(*TAIL_GRAD_CASES[1], torch.float32, 601, device),))):
        if name == "memory_readout":
            q, k, v, ok, d_out = make()
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            fwd = lambda: mr.memory_readout(q, k, v, ok)                    # noqa: E731
            lib_fwd = lambda: memory_readout_dense(q, k, v, ok)             # noqa: E731
        else:
            hidden, f8p, f4p = make()
            hidden.requires_grad_()
            net.decoder.requires_grad_(True)
            params = net.decoder.tail_params(torch.float32)
            d_out = torch.ones((3, 4, 64, 64), device=device)
            fwd = lambda: dt.decode_tail(params, hidden, f8p, f4p)          # noqa: E731
            lib_fwd = lambda: dt.decode_tail_unpacked(params.raw, hidden, f8p, f4p)   # noqa: E731
        out, lib_out = fwd(), lib_fwd()
        fwd_ms = cuda_time_ms(fwd, iters=20, warmup=3)
        bwd_ms = cuda_time_ms(lambda: out.backward(d_out, retain_graph=True), iters=20, warmup=3)
        lib_ms = cuda_time_ms(lambda: lib_out.backward(d_out, retain_graph=True), iters=20, warmup=3)
        log(f"{name} at the trainer's shape: forward (kernel, through the Function) {fwd_ms:.4f} ms, backward "
            f"{bwd_ms:.4f} ms; autograd of the plain dense version's backward {lib_ms:.4f} ms [{smi}]")
        entry = next(e for e in kernels if e["name"] == name)
        entry.update(train_forward_ms=fwd_ms, backward_ms=bwd_ms, backward_grad_share=grad_share[name])
        del out, lib_out
    net.decoder.requires_grad_(False)

    log(f"chip_smoke: {time.perf_counter() - T_START:.1f} s from the start, the build included [{smi}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
