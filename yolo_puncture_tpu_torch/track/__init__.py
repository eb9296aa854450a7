"""The mask tracker of the port: ``TrackerCore`` and its memory."""

from yolo_puncture_tpu_torch.track.core import (  # noqa: F401
    FrameInfo,
    ObjectInfo,
    ObjectManager,
    TrackerCore,
)
from yolo_puncture_tpu_torch.track.memory import MemoryState, init_memory  # noqa: F401


def reference_tracker_geometry(frame_hw, min_side: int = 480):
    """Processing geometry for a (h0, w0) source frame: the shorter side resized
    to ``min_side`` keeping the aspect, each side padded up to a multiple of 16.
    720p → (480, 864).  Returns (th, tw)."""
    h0, w0 = frame_hw
    r = min_side / min(h0, w0)
    th = -(-round(h0 * r) // 16) * 16
    tw = -(-round(w0 * r) // 16) * 16
    return int(th), int(tw)
