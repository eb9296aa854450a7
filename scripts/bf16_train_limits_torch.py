#!/usr/bin/env python3
"""The CPU's bf16-against-fp32 distances behind ``chip_smoke.py`` phase 3za's limits.

    python3 scripts/bf16_train_limits_torch.py [--threads N] [--parts tracker,detector,u2netp]
        [--det-size S] [--mutations]

Runs, on the CPU, what phase 3za compares on the card, at the same
configuration and seeds, in fp32 and in bf16 (fp32 master weights, bf16
compute): one ``PropagationTrainer`` step with ``apps/train_tracker.py``'s
defaults (256², clips of 4, 4 objects, batch 8, seeded init); YOLOv10-S seg's
train-mode head maps at ``--det-size``² (640, the card's), batch 2
(``chip_smoke.polygon_batch``) and the gradient of their seeded random
projection, with each top-level block's scale along fp32's and cosine to it
(``chip_smoke.detector_grad_blocks``); U2NETP's seven maps at 320².  Prints each
relative L1 distance (Σ|bf16 − fp32| / Σ|fp32|) and, as the last line, the JSON
object that ``chip_smoke.BF16_CPU_DISTANCE`` holds.  Minutes on a few cores.

``--mutations`` also holds broken detector gradients to 3za's rule (the band on
the relative L1 distance, and ``DET_GRAD_SCALE`` / ``DET_GRAD_COS`` a block): all
zero, half scale, one block zeroed, 30 % of the signs flipped, and the bf16
backward of a network whose SiLU backward is σ alone or whose train-mode
BatchNorm backward leaves out its statistics' terms.  Each must fail.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402


class _SigmoidOnlySilu(torch.autograd.Function):
    """SiLU whose backward leaves out x·σ'(x): a broken backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * torch.sigmoid(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (g.float() * torch.sigmoid(x.float())).to(g.dtype)


@contextlib.contextmanager
def _broken(kind: str):
    """Inside the block the network computes a broken backward: ``F.silu``'s (the
    activation of every ``ConvBN``) or train-mode ``BatchNorm2d``'s."""
    from yolo_puncture_tpu_torch.nn import common

    if kind == "silu":
        saved = F.silu
        F.silu = lambda x, inplace=False: _SigmoidOnlySilu.apply(x)      # noqa: E731
    else:
        saved = common.BatchNorm2d.forward

        def forward(self, x):                      # the batch's statistics as constants
            if not self.training:
                return saved(self, x)
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3)).detach()
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0).detach()
            mul = torch.rsqrt(var + self.eps) * self.weight
            return ((xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]).to(x.dtype)

        common.BatchNorm2d.forward = forward
    try:
        yield
    finally:
        if kind == "silu":
            F.silu = saved
        else:
            common.BatchNorm2d.forward = saved


def _rule(g16: dict, g32: dict) -> str:
    """3za's rule on a detector gradient: 'pass' or why it fails."""
    try:
        cs.hold_detector_grads("  rule", g16, g32)
    except AssertionError as e:
        return f"fails ({str(e)[:120]})"
    return "passes"


def detector(size: int, mutations: bool) -> dict:
    from yolo_puncture_tpu_torch import YOLO

    images = torch.from_numpy(cs.polygon_batch(cs.DET_TRAIN_B, size, seed=8)["images"][:2])

    def run(dtype):
        return cs.detector_head_vjp(YOLO("yolo10s-seg", nc=1, seed=0, dtype=dtype, device="cpu").model, images)

    t = time.perf_counter()
    maps32, g32 = run(torch.float32)
    maps16, g16 = run(torch.bfloat16)
    out = {"detector_maps": cs.rel_l1(maps16, maps32), "detector_grads": cs.rel_l1(list(g16.values()),
                                                                                   list(g32.values()))}
    blocks = cs.detector_grad_blocks(g16, g32)
    print(f"YOLOv10-S {size}^2 B 2: head maps {out['detector_maps']:.6g}, gradients {out['detector_grads']:.6g}; "
          f"per block scale along fp32's {min(r for r, _ in blocks.values()):.4f}–"
          f"{max(r for r, _ in blocks.values()):.4f}, "
          f"cosine at least {min(c for _, c in blocks.values()):.4f} ({time.perf_counter() - t:.1f} s)", flush=True)
    for k, (r, c) in blocks.items():
        print(f"  {k}: scale {r:.4f}, cosine {c:.4f}")
    if mutations:
        block = next(iter(blocks))
        gen = torch.Generator().manual_seed(1)
        cases = {"the bf16 gradient": g16,
                 "the fp32 gradient (a run that fell back to fp32)": g32,
                 "all zero": {n: torch.zeros_like(g) for n, g in g16.items()},
                 "half scale": {n: g / 2 for n, g in g16.items()},
                 "double scale": {n: g * 2 for n, g in g16.items()},
                 f"block {block} zeroed": {n: torch.zeros_like(g) if n.startswith(block + ".") else g
                                           for n, g in g16.items()},
                 "30 % of the signs flipped": {n: g * torch.where(torch.rand(g.shape, generator=gen) < 0.3, -1.0, 1.0)
                                               for n, g in g16.items()}}
        for kind, what in (("silu", "SiLU's backward as sigma alone"),
                           ("bn", "BatchNorm's backward without its statistics' terms")):
            with _broken(kind):
                cases[what] = run(torch.bfloat16)[1]
        for what, g in cases.items():
            print(f"mutation check, {what}: relative L1 {cs.rel_l1(list(g.values()), list(g32.values())):.4f}, "
                  f"3za's rule {_rule(g, g32)}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--parts", default="tracker,detector,u2netp")
    ap.add_argument("--det-size", type=int, default=640)
    ap.add_argument("--mutations", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    from yolo_puncture_tpu_torch.apps import train_tracker as tt_app

    parts = args.parts.split(",")
    out = {}
    if "tracker" in parts:
        t = time.perf_counter()
        tr32, tr16 = cs.bf16_tracker_pair(tt_app.parse_args(cs.TRACKER_TRAIN_ARGS), "cpu")
        dist = cs.bf16_tracker_step_distance(tr32, tr16, tr16._sample_batch())
        out["tracker_loss"], out["tracker_grads"] = dist["loss"], dist["grads"]
        print(f"tracker step: loss fp32 {dist['loss32']:.6f}, bf16 {dist['loss16']:.6f}; distances {out} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
        del tr32, tr16
    if "detector" in parts:
        out.update(detector(args.det_size, args.mutations))
    if "u2netp" in parts:
        out["u2netp_maps"] = cs.rel_l1(cs.u2netp_maps(torch.bfloat16, 320, "cpu"),
                                       cs.u2netp_maps(torch.float32, 320, "cpu"))
        print(f"U2NETP 320^2: maps {out['u2netp_maps']:.6g}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
