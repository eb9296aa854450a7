#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 3zb alone: data and tensor parallelism on the card.

    python3 scripts/dp_phase_torch.py [--imgsz 640] [--steps 3]

Builds the kernels in this process before any rank starts (ranks that built at
once would race on the build directory; the dry run's serving step launches
``proto_decode``), prints the card's name and power limit, and runs
``chip_smoke.dp_phase``: ``Trainer(mesh=make_mesh())`` on one rank over NCCL
against ``Trainer()``; four spawned ranks on the one card over gloo in layouts
4×1 and 2×2 against the single-process step on the same global batch of
YOLOv10-S seg, ms a step and bytes a step; ``dryrun_multichip(4)``; over NCCL,
one rank a card, where there are cards enough.  Exits non-zero without a card,
and raises where a check fails or a rank fails or hangs.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--steps", type=int, default=cs.DP_TIMED_STEPS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dp_phase_torch: no CUDA device available", file=sys.stderr)
        return 2
    from yolo_puncture_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    cs.log(f"built {_build.build_all()} in {time.perf_counter() - t:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    launches = cs.dp_phase(smi, args.imgsz, steps=args.steps)
    cs.log(f"launches {launches}; {time.perf_counter() - t:.1f} s [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
