"""The benchmark's own tests: the repository root on the path, one torch thread
a worker, and the tiny sizes at which a cell runs on the CPU."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)

# 72×128 frames, a 64² letterbox, the tracker at 48×96, 8 frames a step
TINY = {"config": {"detector": {"imgsz": 64}, "tracker": {"frame_hw": [72, 128], "min_side": 48}},
        "traffic": {"batch": 8, "frame_hw": [72, 128], "bar": {"width": 6, "rows": [20, 52], "speed": 3}}}


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
