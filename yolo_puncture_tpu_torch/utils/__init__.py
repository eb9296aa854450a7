"""Utils namespace: the reference's function surface (``yolo_seg/utils/__init__.py``)
under the same names, as the JAX package's ``utils`` exports it, so code written
against the reference can swap its imports.  ``segment_anything`` and
``show_anns`` come with SAM (ROADMAP item 12c)."""

from yolo_puncture_tpu_torch.utils.config import Config, get_config, load_config  # noqa: F401
from yolo_puncture_tpu_torch.ops.geometry import (  # noqa: F401
    binary_mask_overlay as get_bi_mask,
    create_roi_mask,
    filter_masks,
    min_rect_len as get_coord_min_rect_len,
    min_rect_len_mask as get_bi_min_rect_len,
    polygon_to_mask as get_coord_mask,
)
from yolo_puncture_tpu_torch.ops.signal import (  # noqa: F401
    difference,
    gaussian_smoothing,
    savitzky_golay_smoothing,
)
from yolo_puncture_tpu_torch.analytics.stats import compute_metrics  # noqa: F401
from yolo_puncture_tpu_torch.utils.transform import crop_frame  # noqa: F401
from yolo_puncture_tpu_torch.utils.plotting import plot_speeds  # noqa: F401


def numpy2tensor(frame):
    """BGR uint8 (H, W, 3) → RGB float32 (3, H, W) in [0, 1], as a numpy array
    (the JAX package's ``utils.numpy2tensor``)."""
    import numpy as np

    rgb = frame[..., ::-1].astype(np.float32) / 255.0
    return np.transpose(rgb, (2, 0, 1))


def __getattr__(name):
    # VideoReader and sort_key live in pipeline/, which imports this package
    if name in ("VideoReader", "sort_key"):
        from yolo_puncture_tpu_torch.pipeline import video

        return getattr(video, name)
    raise AttributeError(name)


__all__ = [
    "get_config",
    "load_config",
    "Config",
    "get_coord_min_rect_len",
    "get_bi_min_rect_len",
    "get_coord_mask",
    "get_bi_mask",
    "create_roi_mask",
    "filter_masks",
    "gaussian_smoothing",
    "savitzky_golay_smoothing",
    "difference",
    "plot_speeds",
    "compute_metrics",
    "numpy2tensor",
    "crop_frame",
    "VideoReader",
    "sort_key",
]
