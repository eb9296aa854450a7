"""The model zoo of the port: YOLO v8/v10/v11, EfficientNet, U²-Net, VAN.  Importing it
registers every model name (``registry.py``).  SAM (``models/sam.py``) registers ``sam``
when it is imported, as in the JAX package, which leaves it out of this file too."""

from yolo_puncture_tpu_torch.models.yolo import SCALES, YOLOModel, make_divisible  # noqa: F401
from yolo_puncture_tpu_torch.models.efficientnet import EfficientNet, preprocess_classifier  # noqa: F401
from yolo_puncture_tpu_torch.models.u2net import U2Net, norm_pred  # noqa: F401
from yolo_puncture_tpu_torch.models.van import VAN  # noqa: F401
