from yolo_puncture_tpu_torch.predict.predictor import YOLO, parse_model_name  # noqa: F401
from yolo_puncture_tpu_torch.predict.results import Boxes, Masks, Results  # noqa: F401
