"""yolo_puncture_tpu_torch: the PyTorch/CUDA port of ``yolo_puncture_tpu`` for one NVIDIA H100.

Mirrors the JAX package's layout so each counterpart is easy to find:
  nn/        conv/attention blocks and detection/segmentation heads (NCHW)
  models/    YOLO v8/v10/v11 det+seg
  ops/       letterbox, NMS / v10 top-k, mask decode and paste, contours
  ops/kernels/  hand-written CUDA kernels (sources in csrc/) with plain PyTorch versions
  predict/   ultralytics-compatible ``YOLO(weights).predict`` → Results / Boxes / Masks
  utils/     weight bridge (JAX variables, ultralytics .pt) and device choice

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  The
package imports torch, numpy and scipy only: never jax, flax or yolo_puncture_tpu.
"""

__version__ = "0.1.0"

from yolo_puncture_tpu_torch.predict.predictor import YOLO  # noqa: E402,F401
