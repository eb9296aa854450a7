"""Tasks of the port: the insertion-state classifier (the U-Net task is not ported yet)."""

from yolo_puncture_tpu_torch.tasks.classify import (  # noqa: F401
    load_classify_net,
    predict_images,
    predict_and_find_start_inserted,
    ClassifierNet,
)
