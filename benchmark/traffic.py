"""The one traffic generator: a recording of needle video, made from ``--seed``.

A traffic file (``benchmark/traffic/<name>.json``) gives its parameters:

  * ``batch``: frames a step; ``distinct_batches``: how many batches of distinct
    frames the recording holds, played in a loop;
  * ``frame_hw``: the frames' height and width;
  * ``texture``: [lo, hi), the range of the per-pixel noise of each frame's base;
  * ``bar``: the needle, a bright bar ``width`` pixels wide over rows
    ``rows`` = [top, bottom) of value ``value``, moving ``speed`` pixels a
    frame from a start drawn from the seed, wrapping within the frame;
  * ``long_term``: whether the tracker keeps long-term memory (long recordings);
  * ``conf``, ``max_det``: the detector's confidence threshold and slots;
  * ``check_steps``: how many steps besides the first the correctness check
    takes, at times drawn from the seed.

Every seed gives frames of the same sizes and the same work; only the pixels
and the bar's start change.  The frames are drawn on the device with a
``torch.Generator`` and copied into pinned host memory, from which each step
uploads its batch.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def bar_starts(traffic: Dict, seed: int) -> int:
    """The bar's x at frame 0, drawn from the seed."""
    g = torch.Generator().manual_seed(int(seed) % (2 ** 63))
    w = traffic["frame_hw"][1]
    return int(torch.randint(0, w - traffic["bar"]["width"], (1,), generator=g))


@torch.no_grad()
def frames(traffic: Dict, seed: int, device) -> List[torch.Tensor]:
    """``distinct_batches`` uint8 BGR batches (batch, H, W, 3), in pinned host
    memory when ``device`` is a card (on the CPU otherwise)."""
    B, n = traffic["batch"], traffic["distinct_batches"]
    H, W = traffic["frame_hw"]
    lo, hi = traffic["texture"]
    bar = traffic["bar"]
    gen = torch.Generator(device=device).manual_seed((int(seed) * 7919 + 3) % (2 ** 63))
    x0 = bar_starts(traffic, seed)
    span = W - bar["width"]
    top, bottom = bar["rows"]
    out = []
    for b in range(n):
        batch = torch.randint(lo, hi, (B, H, W, 3), generator=gen, device=device, dtype=torch.uint8)
        for i in range(B):
            x = (x0 + bar["speed"] * (b * B + i)) % span
            batch[i, top:bottom, x:x + bar["width"]] = bar["value"]
        if torch.device(device).type == "cuda":
            batch = torch.empty(batch.shape, dtype=batch.dtype, pin_memory=True).copy_(batch)
        out.append(batch)
    return out
