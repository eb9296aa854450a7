#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``yolo_puncture_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):
  1. build every CUDA kernel from ``yolo_puncture_tpu_torch/csrc`` (one nvcc per
     source, in parallel) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card:
     ``proto_decode``, ``memory_readout`` and ``decode_tail`` (fp32 and bf16);
  3. drive the main paths with every kernel's launch count set to 0 just before
     and read just after, each kernel of a path must have run:
     ``YOLO("yolo10s-seg").predict`` at imgsz 640 on four seeded 720×1280 frames
     (non-retina, then retina), and the mask tracker ``TrackerCore`` at 480×864
     with the shipped needle checkpoint on seeded 720×1280 frames of a moving
     bright bar (``incorporate_detection``, 5× ``step``, ``step_batch`` of 12
     frames, a second ``incorporate_detection``);
  4. run the same calls on the CPU (one frame of predict; the tracker up to its
     first window) and compare;
  5. run the tracker with long-term memory on for 7 frames, once with the
     constructor's defaults and once with a ring of two slots so that
     consolidation fires: this readout returns the attention usage and is plain
     PyTorch, so ``memory_readout``'s count must not move;
  6. time each kernel, its plain version and a PyTorch yardstick with CUDA
     events, and ``predict``, one ``step`` and one window with a synchronised
     host clock.

The line before the last is a JSON object ``{"kernels": [...]}`` with each
kernel's launches on its main path, its error against the plain version, its
times and its bound; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the package beside it, the script exits
non-zero before printing any result.  The detector's weights are a seeded
random init; the tracker's are ``resources/weights/tracker_propagation_needle.msgpack``.
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
FP32_FLOP_PER_S = 67e12

SOFT_ATOL = 1e-6   # soft masks: kernel vs plain version (fp32 sums in another order)
THRESH_BAND = 1e-6  # binary masks may differ only where the soft value is this close to the threshold
# memory_readout and decode_tail against their plain versions, fp32: sums of up to
# 13 k (readout) and 1152 (tail) fp32 terms taken in another order
FP32_TOL = 2e-4
# bf16 readout: both sides round the same fp32 result to bf16, so they differ by
# at most one bf16 ulp (2^-7 relative) where the fp32 values straddle a rounding edge
READOUT_BF16_TOL = 2.0 ** -7
# bf16 tail: an activation rounded the other way (one ulp, 2^-8 relative) moves a
# logit by about 1e-3, and a few hundred of them meet in one logit
TAIL_BF16_TOL = 5e-2
# the tracker on the card against its CPU run: probabilities after 11 recurrent
# frames through cuDNN's and the CPU's convolutions
TRACK_PROB_TOL = 5e-3
TRACK_ID_AGREE = 0.999

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


def readout_inputs(Q, M, No, Cv, dtype, seed, device, valid="all"):
    """Seeded query, keys, values and validity for the memory readout.  ``valid``:
    'all', 'none', 'random' (half), or 'last' (only the last three elements, so
    that the first valid element lies in the last tile)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, 64)).astype(np.float32)
    k = rng.standard_normal((M, 64)).astype(np.float32)
    v = rng.standard_normal((No, M, Cv)).astype(np.float32)
    mask = {"all": np.ones(M, bool), "none": np.zeros(M, bool), "random": rng.random(M) < 0.5,
            "last": np.arange(M) >= M - 3}[valid]
    to = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)  # noqa: E731
    return to(q), to(k), to(v), torch.from_numpy(mask).to(device)


def check_memory_readout(device) -> float:
    """Kernel vs plain version on the card; returns the largest fp32 difference."""
    from yolo_puncture_tpu_torch.ops.kernels.memory_readout import memory_readout, memory_readout_reference

    worst = 0.0
    cases = [  # (Q, M, No, Cv, valid): the window, one frame, ragged, all invalid, late first valid
        (8100, 12968, 4, 128, "all"),
        (8100, 12968, 4, 128, "random"),
        (1620, 12968, 4, 128, "all"),
        (52, 300, 3, 128, "random"),
        (100, 333, 2, 128, "none"),
        (1620, 12968, 4, 128, "last"),
    ]
    for i, (Q, M, No, Cv, valid) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, ok = readout_inputs(Q, M, No, Cv, dtype, 200 + i, device, valid)
            got = memory_readout(q, k, v, ok)
            ref = memory_readout_reference(q, k, v, ok)
            torch.cuda.synchronize()
            if got.dtype != dtype or tuple(got.shape) != (No, Q, Cv) or not torch.isfinite(got).all():
                raise AssertionError(f"memory_readout gave {got.dtype} {tuple(got.shape)}, finite: "
                                     f"{bool(torch.isfinite(got).all())}")
            if valid == "none" and float(got.float().abs().max()) != 0.0:
                raise AssertionError("rows with no valid element must read exact zeros")
            diff = (got.float() - ref.float()).abs()
            if dtype == torch.float32:
                err, tol = float(diff.max()), FP32_TOL
                worst = max(worst, err)
            else:
                err, tol = float((diff / ref.float().abs().clamp_min(1.0)).max()), READOUT_BF16_TOL
            log(f"memory_readout Q={Q} M={M} No={No} Cv={Cv} valid={valid} {str(dtype)[6:]}: "
                f"max {'abs' if dtype == torch.float32 else 'rel-to-max(1,|ref|)'} diff {err:.3g} (tol {tol:.3g})")
            if not err <= tol:
                raise AssertionError(f"memory_readout differs from its plain version by {err} > {tol}")
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


def check_decode_tail(net, device) -> float:
    """Kernel vs plain version (the packed algebra through cuDNN, TF32 off) on the
    card, with the needle checkpoint's decoder; returns the largest fp32 difference."""
    from yolo_puncture_tpu_torch.ops.kernels.decode_tail import decode_tail, decode_tail_reference

    worst = 0.0
    for i, (N, No, H16, W16) in enumerate([(5, 4, 30, 54), (1, 4, 30, 54), (2, 3, 5, 7)]):
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, TAIL_BF16_TOL)):
            params = net.decoder.tail_params(dtype)
            hidden, f8p, f4p = tail_inputs(N, No, H16, W16, dtype, 300 + i, device)
            got = decode_tail(params, hidden, f8p, f4p)
            ref = decode_tail_reference(params, hidden, f8p, f4p)
            torch.cuda.synchronize()
            if got.dtype != torch.float32 or tuple(got.shape) != (N, No, 4 * H16, 4 * W16) \
                    or not torch.isfinite(got).all():
                raise AssertionError(f"decode_tail gave {got.dtype} {tuple(got.shape)}")
            err = float((got - ref).abs().max())
            if dtype == torch.float32:
                worst = max(worst, err)
            log(f"decode_tail N={N} No={No} {H16}x{W16} {str(dtype)[6:]}: max abs diff {err:.3g} "
                f"(tol {tol:.3g}, logits up to {float(ref.abs().max()):.3g})")
            if not err <= tol:
                raise AssertionError(f"decode_tail differs from its plain version by {err} > {tol}")
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


def kernel_entry(name, replaces, launches, max_err, ms, plain_ms, library_ms, bytes_moved, flops) -> dict:
    """One entry of the ``kernels`` line; the bound is the larger of the bytes
    over the memory rate and the operations over the fp32 rate."""
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / FP32_FLOP_PER_S * 1e3
    log(f"{name}: bound {max(bound_bytes_ms, bound_ops_ms):.5f} ms "
        f"(bytes {bound_bytes_ms:.5f} ms, operations {bound_ops_ms:.5f} ms)")
    return {
        "name": name,
        "route": "cuda",
        "source": f"yolo_puncture_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": max_err[name],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": library_ms,
    }


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
    from yolo_puncture_tpu_torch.track import ObjectInfo, TrackerCore
    from yolo_puncture_tpu_torch.track.network import memory_readout_dense

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
    max_err = {"proto_decode": check_proto_decode(device),
               "memory_readout": check_memory_readout(device),
               "decode_tail": check_decode_tail(net, device)}

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
    protos, coeffs, boxes = proto_decode_inputs(B, N, Hp, Wp, nm, 7, device)
    out = torch.empty((B, N, Hp, Wp), dtype=torch.float32, device=device)
    args = kernel_args(protos, coeffs, boxes, out, None, True)
    launch = kernel_fn()
    kernel_ms = cuda_time_ms(lambda: launch(*args), iters=200)  # the bare launch: device time
    wrapper_ms = cuda_time_ms(lambda: proto_decode(protos, coeffs, boxes, None, True), iters=200)
    plain_ms = cuda_time_ms(lambda: proto_decode_reference(protos, coeffs, boxes, None, True))
    pflat = protos.reshape(B, nm, Hp * Wp)
    library_ms = cuda_time_ms(lambda: torch.matmul(coeffs, pflat))
    P = Hp * Wp
    bytes_moved = 4 * (B * nm * P + B * N * nm + B * N * 4 + B * N * P)
    flops = 2 * B * N * P * nm
    log(f"proto_decode B={B} N={N} {Hp}x{Wp}: kernel {kernel_ms:.5f} ms (through the Python "
        f"wrapper {wrapper_ms:.5f} ms), plain {plain_ms:.5f} ms, torch.matmul {library_ms:.5f} ms, "
        f"({bytes_moved} B, {flops} FLOP) [{smi}]")
    kernels = [kernel_entry("proto_decode", "yolo_puncture_tpu/ops/pallas/proto_decode.py:23",
                            launches, max_err, kernel_ms, plain_ms, library_ms, bytes_moved, flops)]
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
                           (8100, torch.bfloat16, False), (1620, torch.bfloat16, False)):
        q, k, v, ok = readout_inputs(Q, M, No, Cv, dtype, 11, device)
        ok[8 * HW:] = False
        out = torch.empty((No, Q, Cv), dtype=dtype, device=device)
        args, launch = mr.kernel_args(q, k, v, ok, out), mr.kernel_fn()
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
        n_valid = int(ok.sum())
        esize = q.element_size()
        flops = 2 * Q * n_valid * (64 + No * Cv)
        bytes_moved = esize * (Q * 64 + n_valid * 64 + No * n_valid * Cv + No * Q * Cv) + M
        log(f"memory_readout Q={Q} M={M} ({n_valid} valid) No={No} Cv={Cv} {str(dtype)[6:]}: kernel {ms:.4f} ms "
            f"(wrapper {wrapper:.4f}), plain {plain:.4f} ms, dense two-matmul {dense:.4f} ms, "
            f"yardstick [{what}] {lib:.4f} ms, ({bytes_moved} B, {flops} FLOP) [{smi}]")
        if keep:
            kernels.append(kernel_entry("memory_readout", "yolo_puncture_tpu/ops/pallas/mem_attention.py:24",
                                        launches, max_err, ms, plain, lib, bytes_moved, flops))
        del q, k, v, ok, out, lib_out

    # -- 6c. decode_tail at the tracker's shapes ------------------------------------------------
    H16, W16 = 30, 54
    for Nf, dtype, keep in ((5, torch.float32, True), (1, torch.float32, False),
                            (5, torch.bfloat16, False), (1, torch.bfloat16, False)):
        params = net.decoder.tail_params(dtype)
        hidden, f8p, f4p = tail_inputs(Nf, 4, H16, W16, dtype, 13, device)
        oskip = dt.skip_plane(params, f4p)
        y8 = torch.empty((Nf * 4, 2 * H16, 2 * W16, 64), dtype=dtype, device=device)
        out = torch.empty((Nf, 4, 4 * H16, 4 * W16), dtype=torch.float32, device=device)
        args, launch = dt.kernel_args(params, hidden, f8p, oskip, y8, out), dt.kernel_fn()
        ms = cuda_time_ms(lambda: launch(*args), iters=20, warmup=3)       # both stages, without the skip plane
        wrapper = cuda_time_ms(lambda: dt.decode_tail(params, hidden, f8p, f4p), iters=20, warmup=3)
        plain = cuda_time_ms(lambda: dt.decode_tail_reference(params, hidden, f8p, f4p), iters=10, warmup=2)
        # yardstick: cuDNN's two packed convolutions alone (fp32, TF32 off), no epilogues
        x8 = hidden.float().reshape(Nf * 4, H16, W16, 128).permute(0, 3, 1, 2).contiguous()
        x4 = y8.float().permute(0, 3, 1, 2).contiguous()
        w8, w4 = params.w8.permute(3, 2, 0, 1).contiguous(), params.w4.permute(3, 2, 0, 1).contiguous()
        lib = cuda_time_ms(lambda: (F.conv2d(x8, w8, padding=1), F.conv2d(x4, w4, padding=1)), iters=10, warmup=2)
        cells, esize = Nf * 4, hidden.element_size()
        flops = 2 * cells * 4 * 256 * (H16 * W16 * 128 + 4 * H16 * W16 * 64) + 2 * cells * 16 * H16 * W16 * 64
        bytes_moved = (esize * (hidden.numel() + f8p.numel() + f4p.numel()) + 4 * out.numel()
                       + 4 * (params.w8.numel() + params.w4.numel() + 2 * params.a8.numel() + 65))
        log(f"decode_tail N={Nf} No=4 {H16}x{W16} {str(dtype)[6:]}: kernel {ms:.4f} ms (wrapper with the skip "
            f"plane {wrapper:.4f}), plain {plain:.4f} ms, cuDNN's two packed convolutions alone {lib:.4f} ms, "
            f"({bytes_moved} B, {flops} FLOP) [{smi}]")
        if keep:
            kernels.append(kernel_entry("decode_tail", "yolo_puncture_tpu/ops/pallas/decode_tail.py:52",
                                        launches, max_err, ms, plain, lib, bytes_moved, flops))
        del hidden, f8p, f4p, oskip, y8, out, x8, x4

    # -- 6d. one step and one window of the tracker, host clock -----------------------------------
    for i in range(1, 6):
        core.step(track_frames[i])                                           # warm-up
    step_frames = [track_frames[6 + (i % 4)] for i in range(10)]
    counts = (mr.memory_readout.launches, dt.decode_tail.launches)
    step_times = host_ms(lambda: [core.step(f) for f in step_frames[:5]])
    per_step = ((mr.memory_readout.launches - counts[0]) / 15, (dt.decode_tail.launches - counts[1]) / 15)
    counts = (mr.memory_readout.launches, dt.decode_tail.launches)
    window_times = host_ms(lambda: core.step_batch(step_frames[:5]))
    per_window = ((mr.memory_readout.launches - counts[0]) / 3, (dt.decode_tail.launches - counts[1]) / 3)
    log(f"tracker 480x864 No=4: 5 steps {sorted(step_times)[1]:.1f} ms median of 3 ({step_times}), launches per "
        f"step (memory_readout, decode_tail) {per_step}; one 5-frame window {sorted(window_times)[1]:.1f} ms "
        f"median of 3 ({window_times}), launches per window {per_window} [{smi}]")
    stages = tracker_stage_ms(core, step_frames[:5])
    log(f"tracker stages ms, synchronised: {json.dumps(stages)}")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
