#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``yolo_puncture_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):
  1. build every CUDA kernel from ``yolo_puncture_tpu_torch/csrc`` (one nvcc per
     source, in parallel) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card;
  3. drive the main path, ``YOLO("yolo10s-seg").predict`` at imgsz 640 on four
     seeded 720×1280 frames (non-retina, then retina), with every kernel's launch
     count set to 0 just before and read just after: each kernel must have run;
  4. run the same predict on the CPU for one frame and compare boxes, scores and masks;
  5. time each kernel, its plain version and a one-call PyTorch yardstick with
     CUDA events, and the batched predict call with a synchronised host clock.

The line before the last is a JSON object ``{"kernels": [...]}`` with each
kernel's launches on the main path, its error against the plain version, its
times and its bound; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the package beside it, the script exits
non-zero before printing any result.  Weights are a seeded random init.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

SOFT_ATOL = 1e-6   # soft masks: kernel vs plain version (fp32 sums in another order)
THRESH_BAND = 1e-6  # binary masks may differ only where the soft value is this close to the threshold


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


def proto_decode_inputs(B, N, Hp, Wp, nm, seed, device):
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((B, nm, Hp, Wp)).astype(np.float32)
    coeffs = (0.5 * rng.standard_normal((B, N, nm))).astype(np.float32)
    x1 = rng.uniform(-5, Wp * 0.6, (B, N))
    y1 = rng.uniform(-5, Hp * 0.6, (B, N))
    boxes = np.stack([x1, y1, x1 + rng.uniform(1, Wp, (B, N)), y1 + rng.uniform(1, Hp, (B, N))], -1)
    boxes[:, ::4] = np.round(boxes[:, ::4])  # integer edges exercise the half-open test
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)  # noqa: E731
    return to(protos), to(coeffs), to(boxes)


def check_proto_decode(device) -> float:
    """Kernel vs plain version on the card; returns the largest soft difference."""
    from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode, proto_decode_reference

    worst = 0.0
    cases = [  # (B, N, Hp, Wp, threshold, crop)
        (4, 32, 160, 160, None, True),
        (4, 32, 160, 160, 0.5, True),
        (4, 32, 160, 160, None, False),
        (4, 32, 160, 160, 0.5, False),
        (3, 37, 100, 168, None, True),
        (3, 37, 100, 168, 0.5, True),
        (2, 70, 33, 45, None, True),  # N > one shared-memory chunk, P not a multiple of 256
    ]
    for i, (B, N, Hp, Wp, thr, crop) in enumerate(cases):
        protos, coeffs, boxes = proto_decode_inputs(B, N, Hp, Wp, 32, 100 + i, device)
        got = proto_decode(protos, coeffs, boxes, thr, crop)
        ref = proto_decode_reference(protos, coeffs, boxes, thr, crop)
        torch.cuda.synchronize()
        if thr is None:
            err = float((got - ref).abs().max())
            worst = max(worst, err)
            log(f"proto_decode B={B} N={N} {Hp}x{Wp} soft crop={crop}: max abs diff {err:.3g}")
            if not err <= SOFT_ATOL:
                raise AssertionError(f"soft masks differ by {err} > {SOFT_ATOL}")
        else:
            soft = proto_decode_reference(protos, coeffs, boxes, None, crop)
            bad = (got != ref) & ((soft - thr).abs() > THRESH_BAND)
            n_diff, n_bad = int((got != ref).sum()), int(bad.sum())
            log(f"proto_decode B={B} N={N} {Hp}x{Wp} thr={thr} crop={crop}: "
                f"{n_diff} binary pixels differ, {n_bad} outside the ±{THRESH_BAND} band")
            if n_bad:
                raise AssertionError(f"{n_bad} binary pixels differ away from the threshold")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from yolo_puncture_tpu_torch import YOLO, _build
    from yolo_puncture_tpu_torch.ops.kernels.proto_decode import (
        kernel_args,
        kernel_fn,
        proto_decode,
        proto_decode_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    t0 = time.perf_counter()
    built = _build.build_all(verbose=True)
    log(f"built {built} in {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # -- 2. kernels against their plain versions -------------------------------
    max_err = check_proto_decode(device)

    # -- 3. the main path ---------------------------------------------------------
    n_frames, h0, w0, imgsz, conf = 4, 720, 1280, 640, 0.018
    frames = seeded_frames(n_frames, h0, w0, seed=0)
    det = YOLO("yolo10s-seg", nc=1, seed=0)
    proto_decode.launches = 0
    res_plain = det.predict(list(frames), conf=conf, imgsz=imgsz, retina_masks=False)
    res_retina = det.predict(list(frames), conf=conf, imgsz=imgsz, retina_masks=True)
    torch.cuda.synchronize()
    launches = proto_decode.launches
    log(f"main path: proto_decode launched {launches} times")
    if launches <= 0:
        raise AssertionError("the main path did not launch the proto_decode kernel")
    for name, res in (("non-retina", res_plain), ("retina", res_retina)):
        counts, px = check_results(res, n_frames, h0, w0)
        log(f"{name}: detections per frame {counts}, mask pixels {px}")

    # -- 4. the same predict on the CPU, one frame --------------------------------
    det_cpu = YOLO("yolo10s-seg", nc=1, seed=0, device="cpu")
    for name, res, retina in (("non-retina", res_plain, False), ("retina", res_retina, True)):
        cpu = det_cpu.predict(frames[0], conf=conf, imgsz=imgsz, retina_masks=retina)[0]
        log(f"GPU vs CPU {name}: {json.dumps(compare_to_cpu(res[0], cpu))}")

    # -- 5. timing at the main path's shapes -----------------------------------------
    B, N, Hp, Wp, nm = n_frames, det.max_masks, imgsz // 4, imgsz // 4, 32
    protos, coeffs, boxes = proto_decode_inputs(B, N, Hp, Wp, nm, 7, device)
    out = torch.empty((B, N, Hp, Wp), dtype=torch.float32, device=device)
    args = kernel_args(protos, coeffs, boxes, out, None, True)
    launch = kernel_fn()
    kernel_ms = cuda_time_ms(lambda: launch(*args), iters=400)  # the bare launch: device time
    wrapper_ms = cuda_time_ms(lambda: proto_decode(protos, coeffs, boxes, None, True), iters=400)
    plain_ms = cuda_time_ms(lambda: proto_decode_reference(protos, coeffs, boxes, None, True))
    pflat = protos.reshape(B, nm, Hp * Wp)
    library_ms = cuda_time_ms(lambda: torch.matmul(coeffs, pflat))
    P = Hp * Wp
    bytes_moved = 4 * (B * nm * P + B * N * nm + B * N * 4 + B * N * P)
    flops = 2 * B * N * P * nm
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / FP32_FLOP_PER_S * 1e3
    log(f"proto_decode B={B} N={N} {Hp}x{Wp}: kernel {kernel_ms:.5f} ms (through the Python "
        f"wrapper {wrapper_ms:.5f} ms), plain {plain_ms:.5f} ms, "
        f"torch.matmul {library_ms:.5f} ms, bound {max(bound_bytes_ms, bound_ops_ms):.5f} ms "
        f"({bytes_moved} B, {flops} FLOP) [{smi}]")

    for retina in (False, True):
        det.predict(list(frames), conf=conf, imgsz=imgsz, retina_masks=retina)  # warm-up
        times = []
        for _ in range(3):
            before = proto_decode.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            det.predict(list(frames), conf=conf, imgsz=imgsz, retina_masks=retina)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            per_call = proto_decode.launches - before
        log(f"predict B={B} {h0}x{w0}@{imgsz} retina={retina}: {sorted(times)[1]:.1f} ms median of 3 "
            f"({times}), proto_decode launches per call {per_call} [{smi}]")
        stages = predict_stage_ms(det, list(frames), conf=conf, imgsz=imgsz, retina_masks=retina)
        log(f"predict stages ms, synchronised, retina={retina}: {json.dumps(stages)}")

    kernels = [{
        "name": "proto_decode",
        "route": "cuda",
        "source": "yolo_puncture_tpu_torch/csrc/proto_decode.cu",
        "replaces": "yolo_puncture_tpu/ops/pallas/proto_decode.py:23",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": library_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
