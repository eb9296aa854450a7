"""Device choice for the port's entry points: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a card raises: there is
    no silent fall-back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, not {dev}")
    return dev
