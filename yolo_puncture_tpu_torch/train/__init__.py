"""Training of the port: the detector's (``Trainer``: task-aligned assignment,
losses, data, mAP), the classifier's and U²-Net's fine-tuners (``finetune.py``)
and, in ``track/train.py``, the tracker's."""

from yolo_puncture_tpu_torch.train.assigner import bbox_ciou, task_aligned_assign  # noqa: F401
from yolo_puncture_tpu_torch.train.losses import detection_loss  # noqa: F401
from yolo_puncture_tpu_torch.train.metrics import compute_map  # noqa: F401
from yolo_puncture_tpu_torch.train.trainer import Trainer, TrainState  # noqa: F401
from yolo_puncture_tpu_torch.train.finetune import (  # noqa: F401
    ClassifierFinetuner,
    UNetFinetuner,
    recalibrate_batch_stats,
)
