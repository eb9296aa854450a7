#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 3z alone: VAN and SAM on the card.

    python3 scripts/zoo_phase_torch.py

Builds the kernels (the VAN pipeline runs ``proto_decode`` through the
detector), prints the card's name and power limit, writes the 67-frame needle
clip of phase 3d (720×1280) as an mp4 under ``build/`` and runs
``chip_smoke.zoo_phase`` at its full sizes: VAN-B0 through ``ClassifierNet``,
the speed pipeline, ``evaluate_speed --cls_model van_b0 --cls_init`` and the
fine-tuner; every VAN variant; SAM ``vit_b`` against the CPU and its generator,
``segment_anything(frame, "vit_l")``, the ``vit_l`` and ``vit_h`` encoders
against their FLOP bounds.  Needs a CUDA device and cv2; exits non-zero without
a card, and raises where a check fails.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("zoo_phase_torch: no CUDA device available", file=sys.stderr)
        return 2
    from yolo_puncture_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    cs.log(f"built {_build.build_all()} in {time.perf_counter() - t:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    clip, _, _ = cs.needle_clip(cs.PIPE_FRAMES, 720, 1280, cs.PIPE_KEY_FRAME, seed=2)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    mp4 = os.path.join(ROOT, "build", "needle.mp4")
    launches = cs.zoo_phase(smi, clip, cs.write_mp4(mp4, list(clip)), mp4)
    cs.log(f"launches {launches}; {time.perf_counter() - t:.1f} s [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
