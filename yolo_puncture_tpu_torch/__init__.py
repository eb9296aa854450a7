"""yolo_puncture_tpu_torch: the PyTorch/CUDA port of ``yolo_puncture_tpu`` for one NVIDIA H100.

Mirrors the JAX package's layout so each counterpart is easy to find:
  nn/        conv/attention blocks and detection/segmentation heads (NCHW)
  models/    YOLO v8/v10/v11 det+seg, EfficientNet, U²-Net, VAN; SAM (models/sam.py)
  ops/       letterbox, NMS / v10 top-k, mask decode and paste, contours
  ops/kernels/  hand-written CUDA kernels (sources in csrc/) with plain PyTorch versions
  predict/   ultralytics-compatible ``YOLO(weights).predict`` → Results / Boxes / Masks
  track/     the mask tracker, its memory and the result saver
  pipeline/  the needle-speed video pipeline; analytics/, tasks/ its host analytics, classifier and U²-Net
  native/    host code in C++ (contours, min-area rectangle, RLE; PNG row filters), built with g++
  apps/      the entry points: track_video, auto_speed_calc, evaluate_speed, speed_freq, serve,
             app, webui, yolo_cli
  utils/     weight bridge (JAX variables, ultralytics .pt, segment-anything .pth), device choice,
             PNG writer and reader, plots, segment_anything / show_anns

The top level exports ``get_config``, ``create_model``, ``register_model``,
``list_models`` and ``YOLO``; importing the package registers every model name.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  The
package imports torch, numpy and scipy only (cv2, PIL and matplotlib where a
file must be decoded or a plot drawn): never jax, flax or yolo_puncture_tpu.
"""

__version__ = "0.1.0"

from yolo_puncture_tpu_torch.utils.config import get_config  # noqa: E402,F401
from yolo_puncture_tpu_torch.registry import create_model, list_models, register_model  # noqa: E402,F401
from yolo_puncture_tpu_torch import models as _models  # noqa: E402,F401  (fills the registry)
from yolo_puncture_tpu_torch.predict.predictor import YOLO  # noqa: E402,F401
