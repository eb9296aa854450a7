"""Key frame, insertion-speed state machine and speed statistics of the port."""

from yolo_puncture_tpu_torch.analytics.keyframe import (  # noqa: F401
    find_insert_start,
    fix_class_prob,
)
from yolo_puncture_tpu_torch.analytics.speed import (  # noqa: F401
    insertion_state_machine,
    insertion_state_machine_torch,
    SpeedResult,
)
from yolo_puncture_tpu_torch.analytics.stats import (  # noqa: F401
    remove_outliers,
    calculate_speed_mm,
    compute_pixel_to_mm_ratio,
    compute_metrics,
)
