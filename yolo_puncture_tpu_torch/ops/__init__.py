"""The port's device and host ops, under the JAX package's ``ops`` names.

``ops.letterbox`` is the function here, as in the JAX package; the module of
that name is ``importlib.import_module("yolo_puncture_tpu_torch.ops.letterbox")``."""

from yolo_puncture_tpu_torch.ops.letterbox import letterbox, letterbox_params, scale_boxes  # noqa: F401
from yolo_puncture_tpu_torch.ops.nms import batched_nms, select_detections, v10_topk_select  # noqa: F401
from yolo_puncture_tpu_torch.ops.masks import crop_masks, decode_masks  # noqa: F401
from yolo_puncture_tpu_torch.ops.signal import (  # noqa: F401
    difference,
    gaussian_smoothing,
    savitzky_golay_smoothing,
)
from yolo_puncture_tpu_torch.ops import geometry  # noqa: F401
