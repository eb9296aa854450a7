#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 3za alone: bf16 training on the card.

    python3 scripts/bf16_train_phase_torch.py [--fp32]

Builds the kernels, prints the card's name and power limit, and runs
``chip_smoke.bf16_train_phase`` at its full sizes: the bf16 backward of the
readout and the decode tail at the tracker trainer's shapes against float64,
``PropagationTrainer`` on a bf16 core with ``train_tracker``'s defaults against
the fp32 step and timed, the detector's ``Trainer`` on bf16 YOLOv10-S seg at
640², and the fine-tuners on bf16 B3, VAN-B0 and U2NETP; then phase 6h's
timing of both kernels' forward and backward at the trainer's shapes, fp32 and
bf16 in turns (``chip_smoke.time_tracker_backward``).  ``--fp32`` first runs
phases 3q and 3r (the fp32 trainers), so that their times stand beside the bf16
ones.  Needs a CUDA device; exits non-zero without one, and raises where a check
fails.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("bf16_train_phase_torch: no CUDA device available", file=sys.stderr)
        return 2
    from yolo_puncture_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    cs.log(f"built {_build.build_all()} in {time.perf_counter() - t:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    fp32 = {}
    if "--fp32" in argv:
        cs.train_tracker_phase(smi, timings=fp32)
        fp32["detector"] = cs.train_detector_phase(smi)
    launches, backward = cs.bf16_train_phase(smi, fp32=fp32)
    for name, entry in cs.time_tracker_backward(smi, cs.needle_network(torch.device("cuda")), "cuda").items():
        backward.setdefault(name, {}).update(entry)
    cs.log(f"bf16 launches {launches}; backward {backward}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
