"""The U²-Net mask-refinement task of the app's video mode.

Counterpart of ``yolo_puncture_tpu/tasks/unet.py``:

  * ``UNetPredictor`` / ``load_unet``: 'u2net' or 'u2netp', with weights from
    the reference's raw state dict (a ``.pth`` file of torch-named tensors,
    ``utils/convert.py export_u2net_state_dict`` writes one from the JAX
    package's variables) or a seeded random init;
  * ``unet_predict``: a BGR uint8 frame → the fused map d0 → min-max
    normalised → ``> 0.5`` → uint8 {0, 255} mask at the input's resolution.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from yolo_puncture_tpu_torch.models.u2net import U2Net, norm_pred
from yolo_puncture_tpu_torch.utils.convert import extract_state_dict
from yolo_puncture_tpu_torch.utils.device import resolve_device


class UNetPredictor:
    """U²-Net (``"u2net"``) or U2NETP (``"u2netp"``) on ``device`` (the card
    unless it says "cpu"), from ``checkpoint`` or a seeded init from ``seed``."""

    def __init__(self, model_name: str = "u2netp", checkpoint: Optional[str] = None, seed: int = 0,
                 device=None):
        if model_name not in ("u2net", "u2netp"):
            raise ValueError(model_name)
        self.device = resolve_device(device)
        self.model = U2Net(small=model_name == "u2netp")
        if checkpoint:
            sd = {k: torch.from_numpy(np.asarray(v)) for k, v in extract_state_dict(checkpoint).items()
                  if not k.endswith("num_batches_tracked")}
            missing, unexpected = self.model.load_state_dict(sd, strict=False)
            missing = [k for k in missing if not k.endswith("num_batches_tracked")]
            if missing or unexpected:
                raise ValueError(f"state dict does not fit {model_name}: missing {missing[:8]}, "
                                 f"unexpected {unexpected[:8]}")
        else:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()

    @torch.no_grad()
    def predict(self, image_bgr_u8: np.ndarray) -> np.ndarray:
        """One BGR frame (H, W, 3) uint8 → uint8 {0, 255} mask (H, W)."""
        x = torch.from_numpy(np.ascontiguousarray(image_bgr_u8)).to(self.device)
        x = x.flip(-1).permute(2, 0, 1)[None].float() / 255.0     # BGR → RGB, /255
        d0 = self.model(x)[0]
        pred = norm_pred(d0[0, 0])
        return ((pred > 0.5).to(torch.uint8) * 255).cpu().numpy()


def load_unet(model_name: str = "u2netp", model_dir: str = "", device=None, **kw) -> UNetPredictor:
    return UNetPredictor(model_name, checkpoint=model_dir or None, device=device, **kw)


def unet_predict(model: UNetPredictor, image: np.ndarray, device=None) -> np.ndarray:
    return model.predict(image)
