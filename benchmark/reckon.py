"""The yardstick's counts: a step's FLOPs, and each kernel's bytes and operations
at its launch shapes, all from the configuration's shapes.

The step's FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s count of the
plain reference's step on the ``meta`` device (no data, no time), with the
decode tail counted as the work it needs (its sub-pixel form: a 3×3
convolution after a nearest ×2 upsample has 4 live taps per output phase, where
the reference's upsample-then-convolve form does 9).  A kernel's bytes count
each input read once and each output written once; its operations are the
products and sums its inputs need.  Nothing here is counted from what the
program executes, so a later program that computes a layer otherwise is read
against the same work.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import tracker as rt
from benchmark.reference import yolo as ry

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def roofline_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over HBM's
    rate and the operations over the bf16 tensor-core peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOP_PER_S)


def tracker_hw(cfg: Dict) -> Tuple[int, int]:
    """The tracker's geometry: the frame's short side at ``min_side``, each
    side padded up to a multiple of 16 (720p → 480×864)."""
    h0, w0 = cfg["tracker"]["frame_hw"]
    r = cfg["tracker"]["min_side"] / min(h0, w0)
    return -(-round(h0 * r) // 16) * 16, -(-round(w0 * r) // 16) * 16


def proto_decode(B: int, N: int, Hp: int, Wp: int, nm: int = 32, esize: int = 2) -> Tuple[int, int]:
    """The soft decode of N masks per frame at prototype resolution: prototypes,
    coefficients and fp32 boxes read, masks written; a product and a sum per
    coefficient and pixel."""
    P = Hp * Wp
    return esize * (B * nm * P + B * N * nm + B * N * P) + 4 * B * N * 4, 2 * B * N * P * nm


def memory_readout(Q: int, M: int, n_valid: int, No: int, Ck: int = 64, Cv: int = 128,
                   esize: int = 2) -> Tuple[int, int]:
    """One readout: the query, the valid keys and values read, the readout
    written, one validity byte per element; logits and the value mix over the
    valid elements."""
    nbytes = esize * (Q * Ck + n_valid * Ck + No * n_valid * Cv + No * Q * Cv) + M
    return nbytes, 2 * Q * n_valid * (Ck + No * Cv)


def decode_tail(N: int, No: int, H16: int, W16: int, Cin: int = 128, Cd: int = 64,
                esize: int = 2) -> Tuple[int, int]:
    """The decode tail of N frames × No objects: hidden state, both projected
    skips and the live-tap weights read, fp32 stride-4 logits written; the two
    sub-pixel 3×3 stages (4 phases × 4 live taps) and the 1×1 head."""
    cells, hw = N * No, H16 * W16
    nbytes = (esize * (cells * hw * Cin + N * 4 * hw * Cd + N * 16 * hw * Cd) + 4 * cells * 16 * hw
              + esize * 16 * (Cin * Cd + Cd * Cd) + 4 * (2 * 2 * 4 * Cd + Cd + 1))
    ops = 2 * cells * 4 * 4 * Cd * (hw * Cin + 4 * hw * Cd) + 2 * cells * 16 * hw * Cd
    return nbytes, ops


def _meta_flops(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def step_flops(cfg: Dict, traffic: Dict) -> int:
    """FLOPs of one step of B frames: the detector (letterbox, forward, the best
    slot's mask) and the tracker's step, on ``meta``."""
    B, d, t = traffic["batch"], cfg["detector"], cfg["tracker"]
    hw = tracker_hw(cfg)
    meta = torch.device("meta")
    with torch.device(meta):
        det = ry.YOLOv10Seg(d["scale"], d["nc"], d["nm"], d["npr"]).eval()
        net = rt.TrackerNet().eval()
    frames = torch.empty((B, *t["frame_hw"], 3), dtype=torch.uint8, device=meta)
    lt = t["max_long_term_elements"] if traffic["long_term"] else 8
    trk = rt.Tracker(net, hw, t["window"], traffic["long_term"], t["num_prototypes"], t["full_res_ids"])
    st = rt.initial_state(hw[0] // 16, hw[1] // 16, t["max_objects"], t["mem_frames"], lt, meta)
    st.valid = [True] * t["mem_frames"]                              # the ring full, as after the first step
    detector = _meta_flops(lambda: ry.detect(det, frames, d["imgsz"], traffic["conf"], traffic["max_det"],
                                             mask_slots=1))
    tracker = _meta_flops(lambda: trk.step(st, frames))
    h16, w16 = hw[0] // 16, hw[1] // 16
    dec = net.decoder
    one_tail = _meta_flops(lambda: dec.tail(torch.empty((t["max_objects"], 128, h16, w16), device=meta),
                                            torch.empty((64, 2 * h16, 2 * w16), device=meta),
                                            torch.empty((64, 4 * h16, 4 * w16), device=meta)))
    packed = decode_tail(B, t["max_objects"], h16, w16)[1]
    return detector + tracker - B * one_tail + packed
