"""Tasks of the port: the insertion-state classifier and the U²-Net mask refinement."""

from yolo_puncture_tpu_torch.tasks.classify import (  # noqa: F401
    load_classify_net,
    predict_images,
    predict_and_find_start_inserted,
    ClassifierNet,
)
from yolo_puncture_tpu_torch.tasks.unet import UNetPredictor, load_unet, unet_predict  # noqa: F401,E402
