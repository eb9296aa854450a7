"""The video speed pipeline of the port and its frame readers."""

from yolo_puncture_tpu_torch.pipeline.video import VideoReader, sort_key, iter_video_frames  # noqa: F401
from yolo_puncture_tpu_torch.pipeline.runner import VideoSpeedPipeline, PipelineOutput  # noqa: F401
